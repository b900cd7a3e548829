// K7: the windowed bilinear sampler over 1x128 row segments. Replaces the
// TPU kernel _sampler_kernel (software_renderer_tpu/ops/texture_kernel.py
// :226); the plain version is sample_segments_windowed_plain in
// software_renderer_tpu_torch/ops/texture_kernel.py.
//
// The TPU kernel walks a segment's 8-row windows because Mosaic's per-lane
// gather lowers only at one [8, 128] vreg. Since the window base y0 is
// 8-aligned, a lane's texel row is (y0 + dy) mod th and its +1 row is the
// next row of the wrap-padded table, so here one thread per lane tests
// dy < 8 * nwin and gathers its four corners per channel straight from
// the padded tables ([C, th + 16, tw] float32; 0.8 MB at 256x256x3, so
// the gathers hit L2). Lanes outside the windows write 0.
//
// Bound: memory. The function needs dy only in segments with a window,
// xa, fx and fy only on lanes inside one, and writes 4 C bytes per lane;
// this kernel reads dy on every lane. The reads are coalesced, the table
// gathers are not.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kWinStride = 8;
constexpr int kWinh = 16;

__global__ void sampler_kernel(const float* __restrict__ tables, int c,
                               int th, int tw, int repeat,
                               const int* __restrict__ xa,
                               const int* __restrict__ dy,
                               const float* __restrict__ fx,
                               const float* __restrict__ fy,
                               const int* __restrict__ y0,
                               const int* __restrict__ nwin, int cap,
                               float* __restrict__ out) {
  const size_t n = (size_t)cap * kLanes;
  const size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int seg = (int)(p / kLanes);
  const int d = dy[p];
  if (!(d >= 0 && d < kWinStride * nwin[seg])) {
    for (int ch = 0; ch < c; ++ch) out[ch * n + p] = 0.0f;
    return;
  }
  // Clamped so that no input indexes outside the tables (as the plain
  // version clamps); rows wrap mod th, as torch.remainder does.
  const int a = min(max(xa[p], 0), tw - 1);
  const int b = repeat ? (a + 1 == tw ? 0 : a + 1) : min(a + 1, tw - 1);
  int ya = (y0[seg] + d) % th;
  if (ya < 0) ya += th;
  const int yb = ya + 1;  // row th is the first wrap-padded row
  const float wx = fx[p], wy = fy[p];
  const size_t plane = (size_t)(th + kWinh) * tw;
  for (int ch = 0; ch < c; ++ch) {
    const float* tab = tables + ch * plane;
    const float t00 = tab[(size_t)ya * tw + a];
    const float t01 = tab[(size_t)ya * tw + b];
    const float t10 = tab[(size_t)yb * tw + a];
    const float t11 = tab[(size_t)yb * tw + b];
    // The plain version's lerp, operation for operation.
    const float top = t00 + (t01 - t00) * wx;
    const float bot = t10 + (t11 - t10) * wx;
    out[ch * n + p] = top + (bot - top) * wy;
  }
}

}  // namespace

extern "C" int sr_sampler(const float* tables, int c, int th, int tw,
                          int repeat, const int* xa, const int* dy,
                          const float* fx, const float* fy, const int* y0,
                          const int* nwin, int cap, float* out,
                          void* stream) {
  if (c < 1 || th < kWinStride || th % kWinStride || tw < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  const size_t n = (size_t)cap * kLanes;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sampler_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tables, c, th, tw, repeat, xa, dy, fx, fy, y0, nwin, cap, out);
  return (int)cudaGetLastError();
}
