// Binned visibility: per pixel, the nearest covering record of its bin's
// list, strict less-than in list (ascending id) order, so the first drawn
// wins ties. Replaces the TPU kernel _binned_vis_kernel
// (software_renderer_tpu/ops/binning.py:607); the plain version is
// binned_vis_plain in software_renderer_tpu_torch/ops/binning.py.
//
// Layout as in fused.cu: the records of bin b are rows bin_start[b] ..
// bin_start[b+1] of `rows` (row width wtot; only the first 11 columns, the
// edges, depth plane and id, are read). One block of 256 threads covers a
// 16-row slab of one bin: grid.x walks the bins, grid.y the slabs of a bin.
// Thread t owns column t % 128 and rows (t / 128) + 2 i, i < 8, and keeps
// their depth and id in registers. Binned records are coverage-safe, so
// there is no bbox clamp. Every pixel of every bin is written, empty bins
// included.
//
// Bound: arithmetic, about 18 float operations per (pixel, record) pair;
// records are read once per block and broadcast from shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlabH = 16;                               // rows per block
constexpr int kPix = kSlabH * sr::kTileW / kThreads;     // pixels per thread
constexpr int kCols = 11;                                // columns read
constexpr int kChunk = 128;                              // records per pass

__global__ void __launch_bounds__(kThreads) binned_vis_kernel(
    const float* __restrict__ rows, int wtot,
    const int* __restrict__ bin_start, int width, int height, int y_start,
    int tile_h, int bands, int gw, float* __restrict__ z_out,
    int* __restrict__ id_out) {
  __shared__ float srec[kChunk * kCols];
  const int b = blockIdx.x;
  const int band_h = tile_h / bands;
  const int tile = b / bands, band = b % bands;
  const int x = (tile % gw) * sr::kTileW + (threadIdx.x % sr::kTileW);
  const int y_first = (tile / gw) * tile_h + band * band_h +
                      blockIdx.y * kSlabH + threadIdx.x / sr::kTileW;
  const float xs = (float)x + 0.5f;

  float ys[kPix], z[kPix];
  int id[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    ys[i] = (float)(y_first + 2 * i + y_start) + 0.5f;
    z[i] = INFINITY;
    id[i] = -1;
  }

  const int start = bin_start[b], end = bin_start[b + 1];
  for (int base = start; base < end; base += kChunk) {
    const int cnt = min(kChunk, end - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt * kCols; j += kThreads)
      srec[j] = rows[(size_t)(base + j / kCols) * wtot + j % kCols];
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float* r = srec + k * kCols;
      const float a0 = r[0], a1 = r[1], b0 = r[2], b1 = r[3], c0 = r[4],
                  c1 = r[5], dabs = r[6], zx = r[7], zy = r[8], zc = r[9];
      const int tri = (int)r[10];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        float e0 = a0 * xs + b0 * ys[i] + c0;
        float e1 = a1 * xs + b1 * ys[i] + c1;
        float e2 = dabs - e0 - e1;
        bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
        float depth = zx * xs + zy * ys[i] + zc;
        float cand = inside ? depth : INFINITY;
        if (cand < z[i]) {
          z[i] = cand;
          id[i] = tri;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int y = y_first + 2 * i;
    if (x >= width || y >= height) continue;
    const size_t p = (size_t)y * width + x;
    z_out[p] = z[i];
    id_out[p] = id[i];
  }
}

}  // namespace

extern "C" int sr_binned_vis(const float* rows, int wtot, const int* bin_start,
                             int nbins, int width, int height, int y_start,
                             int tile_h, int bands, int gw, float* z_out,
                             int* id_out, void* stream) {
  if (wtot < kCols || (tile_h / bands) % kSlabH)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nbins, (tile_h / bands) / kSlabH);
  binned_vis_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rows, wtot, bin_start, width, height, y_start, tile_h, bands, gw, z_out,
      id_out);
  return (int)cudaGetLastError();
}
