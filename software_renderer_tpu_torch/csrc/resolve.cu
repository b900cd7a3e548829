// G-buffer resolve over the bins: per pixel, the attribute planes of its
// winning triangle, px * x + py * y + pc per channel, where the winner is
// in the pixel's bin, and 0 where it is not (uncovered pixels; overflow
// winners are added afterwards by resolve_merge.cu). Replaces the TPU
// kernel _resolve_kernel (software_renderer_tpu/ops/binning.py:663); the
// plain version is resolve_plain in software_renderer_tpu_torch/ops/
// binning.py.
//
// The TPU kernel walks a tile's whole list and selects where the id
// matches. A bin lists each id at most once and in ascending order, so
// here one thread per pixel binary-searches its winner in its bin's CSR
// slice: O(log n) reads of the id column instead of n.
//
// Bound: memory, one id read and A plane writes per pixel (plus the
// searched id column, mostly from L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void resolve_kernel(const float* __restrict__ rows, int wtot,
                               int n_channels,
                               const int* __restrict__ bin_start,
                               const int* __restrict__ tid, int width,
                               int height, int y_start, int tile_h, int bands,
                               int gw, float* __restrict__ gb) {
  const size_t npix = (size_t)width * height;
  const size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int x = (int)(p % width), y = (int)(p / width);
  const int band_h = tile_h / bands;
  const int b = ((y / tile_h) * gw + x / sr::kTileW) * bands +
                (y % tile_h) / band_h;
  const int t = tid[p];
  int found = -1;
  if (t >= 0) {
    int lo = bin_start[b], hi = bin_start[b + 1];
    const int end = hi;
    while (lo < hi) {  // first row of the bin whose id >= t
      const int mid = (lo + hi) >> 1;
      if ((int)rows[(size_t)mid * wtot + 10] < t) lo = mid + 1;
      else hi = mid;
    }
    if (lo < end && (int)rows[(size_t)lo * wtot + 10] == t) found = lo;
  }
  const float xs = (float)x + 0.5f;
  const float ys = (float)(y + y_start) + 0.5f;
  for (int a = 0; a < n_channels; ++a) {
    float v = 0.0f;
    if (found >= 0) {
      const float* r = rows + (size_t)found * wtot + 11 + 3 * a;
      v = r[0] * xs + r[1] * ys + r[2];
    }
    gb[a * npix + p] = v;
  }
}

}  // namespace

extern "C" int sr_resolve(const float* rows, int wtot, int n_channels,
                          const int* bin_start, const int* tid, int width,
                          int height, int y_start, int tile_h, int bands,
                          int gw, float* gb, void* stream) {
  if (wtot != 11 + 3 * n_channels || tile_h % bands)
    return (int)cudaErrorInvalidValue;
  const size_t npix = (size_t)width * height;
  const unsigned blocks = (unsigned)((npix + kThreads - 1) / kThreads);
  resolve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, wtot, n_channels, bin_start, tid, width, height, y_start, tile_h,
      bands, gw, gb);
  return (int)cudaGetLastError();
}
