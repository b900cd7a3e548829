// K7: the windowed bilinear sampler over 1x128 row segments. Replaces the
// TPU kernel _sampler_kernel (software_renderer_tpu/ops/texture_kernel.py
// :226); the plain version is sampler_plain in
// software_renderer_tpu_torch/ops/texture_kernel.py.
//
// The TPU kernel walks a segment's 8-row windows because Mosaic's per-lane
// gather lowers only at one [8, 128] vreg. Since the window base y0 is
// 8-aligned, a lane's texel row is (y0 + dy) mod th and its +1 row is the
// next row of the wrap-padded table, so here each lane tests dy < 8 * nwin
// and gathers its four corners straight from the texels: a
// [th + 16, tw, 4] float32 table, the texture's channels interleaved per
// texel and padded to 4 (1.1 MB at 256x256, L2-resident), so that a
// corner is one 16-byte load whatever C is.
//
// Bound: memory. The function must write 4 C bytes per lane, and needs dy
// only in segments with a window and xa, fx and fy only on lanes inside
// one; most segments of a frame have none (16-38% are covered on the
// north-star scene). Design:
// * One warp per segment, 4 lanes a thread: the warp reads nwin once, and
//   the branch on it is uniform. A segment with no window writes zeros and
//   reads no per-lane input.
// * dy, xa, fx and fy arrive in 16-byte loads, and each channel's 4 lanes
//   leave in one 16-byte store; xa, fx and fy are read only by a thread
//   with a lane inside a window.
// * No integer division on the path: with 0 <= y0 < th and 8 * nwin <= th,
//   as windowed_prep makes them, y0 + dy < 2 th wraps with one subtraction;
//   other inputs take the remainder, as the plain version does.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // segments per block
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 128;
constexpr int kPer = 4;                   // lanes per thread
constexpr int kWinStride = 8;
constexpr int kWinh = 16;
constexpr int kMaxC = 4;

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
sampler_kernel(const float4* __restrict__ texels, int c, int th, int tw,
               int repeat, const int4* __restrict__ xa,
               const int4* __restrict__ dy, const float4* __restrict__ fx,
               const float4* __restrict__ fy, const int* __restrict__ y0,
               const int* __restrict__ nwin, int cap,
               float4* __restrict__ out) {
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= cap) return;  // whole warps
  const size_t plane = (size_t)cap * (kLanes / kPer);  // float4s a channel
  const size_t q = (size_t)seg * (kLanes / kPer) + (threadIdx.x & 31);
  float res[kMaxC][kPer] = {};
  const int nw = nwin[seg];
  if (nw > 0) {
    const int lim = kWinStride * nw;
    const int4 d = dy[q];
    bool in[kPer];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      in[k] = lane_of(d, k) >= 0 && lane_of(d, k) < lim;
      any = any || in[k];
    }
    if (any) {
      const int base = y0[seg];
      const bool fast = base >= 0 && base < th && lim <= th;
      const int4 x = xa[q];
      const float4 wx4 = fx[q], wy4 = fy[q];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (!in[k]) continue;
        // Clamped so that no input indexes outside the table (as the
        // plain version clamps); rows wrap mod th, as torch.remainder.
        const int a = min(max(lane_of(x, k), 0), tw - 1);
        const int b = repeat ? (a + 1 == tw ? 0 : a + 1) : min(a + 1, tw - 1);
        int ya = base + lane_of(d, k);
        if (fast) {
          ya = ya >= th ? ya - th : ya;
        } else {
          ya %= th;
          ya = ya < 0 ? ya + th : ya;
        }
        const size_t r0 = (size_t)ya * tw;  // row ya + 1 is the next row
        const float4 t00 = texels[r0 + a], t01 = texels[r0 + b];
        const float4 t10 = texels[r0 + tw + a], t11 = texels[r0 + tw + b];
        const float wx = lane_of(wx4, k), wy = lane_of(wy4, k);
#pragma unroll
        for (int ch = 0; ch < kMaxC; ++ch) {
          // The plain version's lerp, operation for operation.
          const float p00 = lane_of(t00, ch), p01 = lane_of(t01, ch);
          const float p10 = lane_of(t10, ch), p11 = lane_of(t11, ch);
          const float top = p00 + (p01 - p00) * wx;
          const float bot = p10 + (p11 - p10) * wx;
          res[ch][k] = top + (bot - top) * wy;
        }
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch)
    if (ch < c)
      out[ch * plane + q] = make_float4(res[ch][0], res[ch][1], res[ch][2],
                                        res[ch][3]);
}

}  // namespace

// texels: [th + 16, tw, 4] float32; xa, dy, fx, fy: [cap, 128]; out:
// [c, cap, 128] float32. Every array 16-byte aligned.
extern "C" int sr_sampler(const float* texels, int c, int th, int tw,
                          int repeat, const int* xa, const int* dy,
                          const float* fx, const float* fy, const int* y0,
                          const int* nwin, int cap, float* out,
                          void* stream) {
  if (c < 1 || c > kMaxC || th < kWinStride || th % kWinStride || tw < 1 ||
      cap < 0)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((cap + kWarps - 1) / kWarps);
  sampler_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(texels), c, th, tw, repeat,
      reinterpret_cast<const int4*>(xa), reinterpret_cast<const int4*>(dy),
      reinterpret_cast<const float4*>(fx),
      reinterpret_cast<const float4*>(fy), y0, nwin, cap,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
