// Overflow G-buffer resolve: where a pixel's winning triangle id is one of
// the live overflow records, write that record's attribute planes
// px * x + py * y + pc; elsewhere copy the seed G-buffer, or, with none,
// write nothing (the fused kernel reads the seed planes only where the
// seed's id won, and a count of 0 then costs one read a thread). Replaces the TPU kernel _resolve_merge_kernel
// (software_renderer_tpu/ops/binning.py:683); the plain version is
// resolve_merge_plain in software_renderer_tpu_torch/ops/binning.py.
//
// The rows are a static list; a device count n_live (JAX's n_live) says
// how many are live, so no count reaches the host.
//
// The TPU kernel walks every record for every tile. Here each pixel finds
// its id among the records by binary search (the rows are sorted by id),
// so the work is O(log n) per pixel instead of O(n).
//
// Bound: memory, one read of the id and seed planes and one write of the
// output planes per pixel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void resolve_merge_kernel(
    const float* __restrict__ rows, int n, const int* __restrict__ n_live,
    int wtot, int n_channels, const int* __restrict__ tid,
    const float* __restrict__ gb_in, int width, int height, int y_start,
    float* __restrict__ gb_out) {
  const size_t npix = (size_t)width * height;
  const size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  if (n_live != nullptr) n = max(0, min(n, __ldg(n_live)));
  if (gb_in == nullptr && n == 0) return;
  const int t = tid[p];
  int found = -1;
  if (t >= 0 && n > 0) {
    int lo = 0, hi = n;  // first live row whose id >= t
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if ((int)rows[(size_t)mid * wtot + 10] < t) lo = mid + 1;
      else hi = mid;
    }
    if (lo < n && (int)rows[(size_t)lo * wtot + 10] == t) found = lo;
  }
  if (gb_in == nullptr && found < 0) return;
  const float xs = (float)(p % width) + 0.5f;
  const float ys = (float)((int)(p / width) + y_start) + 0.5f;
  for (int a = 0; a < n_channels; ++a) {
    float v = gb_in != nullptr ? gb_in[a * npix + p] : 0.0f;
    if (found >= 0) {
      const float* r = rows + (size_t)found * wtot + 11 + 3 * a;
      v = r[0] * xs + r[1] * ys + r[2];
    }
    gb_out[a * npix + p] = v;
  }
}

}  // namespace

// n_live: a device pointer to the live row count, or null for all n;
// gb_in: the seed planes, or null (only the found pixels are written).
extern "C" int sr_resolve_merge(const float* rows, int n, const int* n_live,
                                int wtot, int n_channels, const int* tid,
                                const float* gb_in, int width, int height,
                                int y_start, float* gb_out, void* stream) {
  const size_t npix = (size_t)width * height;
  const unsigned blocks = (unsigned)((npix + kThreads - 1) / kThreads);
  if (blocks == 0) return (int)cudaSuccess;
  resolve_merge_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, n, n_live, wtot, n_channels, tid, gb_in, width, height, y_start,
      gb_out);
  return (int)cudaGetLastError();
}
