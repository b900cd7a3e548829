// K8: the gather probe's two kernels (software_renderer_tpu_torch/tools/
// probe_dyngather.py). Replace the TPU probe's Pallas kernels in
// tools/probe_dyngather.py: window_kernel (:97) and shape_probe's kern
// (:69). The plain versions are window_lookup_plain (tab[ty, tx]) and
// torch.take_along_axis.
//
// sr_window_lookup: one block per 1x128 segment stages the segment's
// [8, tw] table window at row y0 in shared memory with coalesced loads,
// then each of the 128 threads picks (ty - y0, tx) out of it. The TPU
// needed the window because its per-lane gather works on one vreg; here
// it measures a staged lookup against the library's row gather.
//
// sr_take_along_axis: out[i, j] = x[idx[i, j], j] (axis 0) or
// x[i, idx[i, j]] (axis 1), one thread per element.
//
// Both are bound by memory: the index and output traffic, plus the table
// once. Indices are clamped into the table, so no input reads outside it.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWin = 8;
constexpr int kThreads = 256;

__global__ void window_lookup_kernel(const float* __restrict__ tab, int th,
                                     int tw, const int* __restrict__ y0,
                                     const int* __restrict__ ty,
                                     const int* __restrict__ tx,
                                     float* __restrict__ out) {
  extern __shared__ float win[];  // [kWin, tw]
  const int seg = blockIdx.x;
  const int base = min(max(y0[seg], 0), th - 1);
  for (int i = threadIdx.x; i < kWin * tw; i += kLanes) {
    const int row = min(base + i / tw, th - 1);
    win[i] = tab[(size_t)row * tw + i % tw];
  }
  __syncthreads();
  const size_t p = (size_t)seg * kLanes + threadIdx.x;
  const int r = min(max(ty[p] - base, 0), kWin - 1);
  const int col = min(max(tx[p], 0), tw - 1);
  out[p] = win[r * tw + col];
}

__global__ void take_along_axis_kernel(const float* __restrict__ x, int s,
                                       int l, const int* __restrict__ idx,
                                       int axis, float* __restrict__ out) {
  const size_t n = (size_t)s * l;
  const size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int i = (int)(p / l), j = (int)(p % l);
  const int k = idx[p];
  out[p] = axis == 0 ? x[(size_t)min(max(k, 0), s - 1) * l + j]
                     : x[(size_t)i * l + min(max(k, 0), l - 1)];
}

}  // namespace

extern "C" int sr_window_lookup(const float* tab, int th, int tw,
                                const int* y0, const int* ty, const int* tx,
                                int segs, float* out, void* stream) {
  const size_t smem = (size_t)kWin * tw * sizeof(float);
  if (th < 1 || tw < 1 || segs < 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (segs == 0) return (int)cudaSuccess;
  window_lookup_kernel<<<segs, kLanes, smem, (cudaStream_t)stream>>>(
      tab, th, tw, y0, ty, tx, out);
  return (int)cudaGetLastError();
}

extern "C" int sr_take_along_axis(const float* x, int s, int l,
                                  const int* idx, int axis, float* out,
                                  void* stream) {
  if (s < 1 || l < 1 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)s * l;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  take_along_axis_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, s, l, idx, axis, out);
  return (int)cudaGetLastError();
}
