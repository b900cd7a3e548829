// K8: the gather probe's two kernels (software_renderer_tpu_torch/tools/
// probe_dyngather.py). Replace the TPU probe's Pallas kernels in
// tools/probe_dyngather.py: window_kernel (:97) and shape_probe's kern
// (:69). The plain versions are window_lookup_plain (tab[ty, tx]) and
// torch.take_along_axis.
//
// sr_window_lookup: each thread takes four neighbouring lanes of one
// 1x128 segment: one 16-byte load each of their ty and tx, the segment's
// y0, four texel loads through the read-only path, one 16-byte store. A
// lane's row is its ty clamped into the segment's 8-row window at y0, as
// the TPU kernel's window allows. The TPU staged the window because its
// per-lane gather works within one vreg; on this card the table (256 KB in
// the probe) stays in L2, and a staged window would read 8 KB per segment
// to use 512 B of it.
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
                                     const int4* __restrict__ ty,
                                     const int4* __restrict__ tx,
                                     size_t quads, float4* __restrict__ out) {
  const size_t q = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int base = min(max(__ldg(y0 + q / (kLanes / 4)), 0), th - 1);
  const int4 y = __ldg(ty + q);
  const int4 x = __ldg(tx + q);
  auto texel = [&](int yy, int xx) {
    const int row = min(base + min(max(yy - base, 0), kWin - 1), th - 1);
    const int col = min(max(xx, 0), tw - 1);
    return __ldg(tab + (size_t)row * tw + col);
  };
  out[q] = make_float4(texel(y.x, x.x), texel(y.y, x.y), texel(y.z, x.z),
                       texel(y.w, x.w));
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
  if (th < 1 || tw < 1 || segs < 0) return (int)cudaErrorInvalidValue;
  if (segs == 0) return (int)cudaSuccess;
  const size_t quads = (size_t)segs * (kLanes / 4);
  const unsigned blocks = (unsigned)((quads + kThreads - 1) / kThreads);
  window_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tab, th, tw, y0, reinterpret_cast<const int4*>(ty),
      reinterpret_cast<const int4*>(tx), quads, reinterpret_cast<float4*>(out));
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
