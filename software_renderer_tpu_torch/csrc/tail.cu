// The texture tail: the fused kernel's output planes to RGBA in one pass.
// Per pixel: the covered test on the triangle id, the bilinear sample of
// the quad table, the combine with the fused colour and specular, the
// mask and alpha, one 16-byte store. Replaces the torch operations of
// finish_fused (software_renderer_tpu_torch/ops/shading.py), its plain
// version, on frames that need no gradient; in the JAX package the
// quad-table sampler and the combine are an XLA stage (ops/shading.py
// finish_fused, ops/texture.py sample_texture_planes), not a kernel.
//
// The torch tail is about 60 operations over whole frames: the index
// arithmetic, one [H, W] -> [H, W, 4C] row gather, the lerps, the
// combine, four masks and the stack into [H, W, 4], each intermediate a
// round trip through HBM. Here every pixel is read and written once.
//
// Bound: memory. Per pixel the id (4 bytes) and the RGBA (16 bytes out);
// per covered pixel its output planes (3, 5 or 6 floats) and one quad-table
// row (4C floats, L2-resident: 3.1 MB at 256x256, C = 3). Design:
// * One thread per pixel over an SM-sized grid-stride loop: consecutive
//   threads read consecutive floats of each plane and write consecutive
//   16-byte RGBA texels.
// * An uncovered pixel reads only its id and writes zeros.
// * The row arrives in C 16-byte loads through the read-only path.
// * Every expression is finish_fused's, in its order, with its
//   float-to-int32 conversion (truncation of the floor) and torch's
//   integer remainder; the build's --fmad=false keeps each multiply and
//   add rounded apart, so the colour equals the torch tail bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

// The channel plans of ops/shading.py fused_output_channels that take the
// kernel: the colour planes alone (final or rgb), rgb + uv, and lit +
// spec + uv.
enum Plan { kColour = 0, kTex = 1, kTexSpec = 2 };

// torch.remainder (repeat) or torch.clamp (clamp) of an int32 index.
template <bool kRepeat>
__device__ __forceinline__ int wrap_index(int i, int n) {
  if (kRepeat) {
    const int r = i % n;
    return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
  }
  return min(max(i, 0), n - 1);
}

template <int kPlan, int kC, bool kRepeat>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tail_kernel(const float* __restrict__ planes, const int* __restrict__ tid,
            size_t npix, const float4* __restrict__ table, int th, int tw,
            const float* __restrict__ specular, float4* __restrict__ out) {
  constexpr int kUv = kPlan == kTexSpec ? 4 : 3;  // the u plane
  float ks[3] = {0.0f, 0.0f, 0.0f};
  if (kPlan == kTexSpec) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ks[c] = __ldg(specular + c);
  }
  const size_t step = (size_t)gridDim.x * kThreads;
  for (size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x; p < npix;
       p += step) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid[p] != -1) {
      float rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = planes[c * npix + p];
      if (kPlan != kColour) {
        // sample_texture_planes: x = u * tw - 0.5, its floor and fraction,
        // the wrapped texel, one quad-table row.
        const float x = planes[kUv * npix + p] * (float)tw - 0.5f;
        const float y = planes[(kUv + 1) * npix + p] * (float)th - 0.5f;
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = x - x0, fy = y - y0;
        const int xa = wrap_index<kRepeat>((int)x0, tw);
        const int ya = wrap_index<kRepeat>((int)y0, th);
        const float4* row = table + (size_t)(ya * tw + xa) * kC;
        float q[4 * kC];  // t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          const float4 v = __ldg(row + i);
          q[4 * i] = v.x;
          q[4 * i + 1] = v.y;
          q[4 * i + 2] = v.z;
          q[4 * i + 3] = v.w;
        }
        constexpr int kN = kC < 3 ? kC : 3;  // channels sampled
        float tex[kN];
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const float t00 = q[c], t01 = q[kC + c];
          const float t10 = q[2 * kC + c], t11 = q[3 * kC + c];
          const float top = t00 + (t01 - t00) * fx;
          const float bot = t10 + (t11 - t10) * fx;
          tex[c] = top + (bot - top) * fy;
        }
        // A single-channel texture serves all three channels.
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * tex[kN == 1 ? 0 : c];
        if (kPlan == kTexSpec) {
          const float s = planes[3 * npix + p];
#pragma unroll
          for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + ks[c] * s;
        }
      }
      o = make_float4(rgb[0], rgb[1], rgb[2], 1.0f);
    }
    out[p] = o;
  }
}

template <int kPlan, int kC, bool kRepeat>
void launch(unsigned blocks, cudaStream_t stream, const float* planes,
            const int* tid, size_t npix, const float* table, int th, int tw,
            const float* specular, float* out) {
  tail_kernel<kPlan, kC, kRepeat><<<blocks, kThreads, 0, stream>>>(
      planes, tid, npix, reinterpret_cast<const float4*>(table), th, tw,
      specular, reinterpret_cast<float4*>(out));
}

template <int kPlan>
int launch_textured(int c, int repeat, unsigned blocks, cudaStream_t stream,
                    const float* planes, const int* tid, size_t npix,
                    const float* table, int th, int tw, const float* specular,
                    float* out) {
#define SR_TAIL(C)                                                         \
  if (c == C) {                                                            \
    if (repeat)                                                            \
      launch<kPlan, C, true>(blocks, stream, planes, tid, npix, table, th, \
                             tw, specular, out);                           \
    else                                                                   \
      launch<kPlan, C, false>(blocks, stream, planes, tid, npix, table,    \
                              th, tw, specular, out);                      \
    return (int)cudaGetLastError();                                        \
  }
  SR_TAIL(1)
  SR_TAIL(3)
  SR_TAIL(4)
#undef SR_TAIL
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// planes: [n_planes, npix] float32, the plan's output planes (3, 5 or 6);
// tid: [npix] int32; table: [th * tw, 4 c] float32 (plans 1 and 2), every
// row 16-byte aligned; specular: [3] float32 (plan 2); out: [npix, 4]
// float32, 16-byte aligned. c is 1, 3 or 4 for the textured plans.
extern "C" int sr_tail(const float* planes, const int* tid, int npix,
                       int plan, const float* table, int th, int tw, int c,
                       int repeat, const float* specular, float* out,
                       int sm_count, void* stream) {
  if (npix < 0 || plan < kColour || plan > kTexSpec || sm_count < 1 ||
      (plan != kColour && (th < 1 || tw < 1)))
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return (int)cudaSuccess;
  const size_t n = (size_t)npix;
  const size_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(
      want < (size_t)sm_count * kBlocksPerSm ? want
                                             : (size_t)sm_count * kBlocksPerSm);
  const cudaStream_t s = (cudaStream_t)stream;
  if (plan == kColour) {
    launch<kColour, 1, true>(blocks, s, planes, tid, n, table, th, tw,
                             specular, out);
    return (int)cudaGetLastError();
  }
  if (plan == kTex)
    return launch_textured<kTex>(c, repeat, blocks, s, planes, tid, n, table,
                                 th, tw, specular, out);
  return launch_textured<kTexSpec>(c, repeat, blocks, s, planes, tid, n,
                                   table, th, tw, specular, out);
}
