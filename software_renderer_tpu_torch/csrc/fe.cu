// K1, the planar front-end: vertex transform + triangle setup, and the
// [T, 11 + 3A] stream table that the bin walk (K2/K5, fused.cu) reads.
// Replaces the TPU kernel _fe_kernel
// (software_renderer_tpu/ops/frontend_kernel.py:42) and the XLA stages
// beside it that build the attribute planes and the stream table. Plain
// versions: _front_math in software_renderer_tpu_torch/ops/frontend.py
// (the 24 rows) and stream_table_planar(attribute_plane_cols(...)) (the
// table); this kernel repeats their operations in the same order.
//
// Bound: memory. Per triangle 36 bytes of corners and 12 A bytes of
// corner attributes in, 96 bytes of rows and 44 + 12 A bytes of table out
// (37 MB at 100k triangles and A = 8), for about 200 + 18 A float
// operations. Design:
// * One pass writes the rows and the table, so the planes, ids and poison
//   rows cost no launches of their own (on the TPU, XLA fuses them).
// * 128-thread blocks: 100k triangles make ~780 blocks, ~6 on each of the
//   132 SMs, all resident at once.
// * The 16 transform scalars are read once per block into shared memory;
//   each thread's corner attributes are loaded before the setup math, so
//   their latency hides behind it.
// * A table row is 44 + 12 A bytes, so a warp storing its rows directly
//   writes 32 scattered pieces; instead each block stages its rows in
//   shared memory and stores the block's contiguous slice of the table in
//   16-byte chunks.
// * A is a runtime count up to kMaxChannels.
// * kPersp (perspective-correct attributes) replaces the XLA stage that
//   JAX runs beside its kernel, perspective_chan_vals
//   (software_renderer_tpu/ops/frontend.py:298; plain version of the same
//   name in ops/frontend.py): each corner value is multiplied by the
//   corner's 1 / w, with the w this thread has just computed, and a last
//   channel 1/w joins the table. Computing w again in torch before the
//   kernel would repeat the transform.
#include "setup.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChannels = 9;
constexpr int kRec = 11;  // a0 a1 b0 b1 c0 c1 |D| zx zy zc id
constexpr int kMaxCols = kRec + 3 * kMaxChannels;

// One thread per triangle; kTable adds the stream table of ``a`` attribute
// channels ([3a, t] corner columns, v1 v2 v3 per channel), kPersp their
// values over w and a channel 1/w (a + 1 <= kMaxChannels).
template <bool kTable, bool kPersp>
__global__ void __launch_bounds__(kThreads)
fe_kernel(const float* __restrict__ cols, int t, const float* __restrict__ m,
          const float* __restrict__ attrs, int a, int width, int height,
          int cull, int ccw, float near_eps, float* __restrict__ out,
          float* __restrict__ table) {
  __shared__ float mm[16];
  __shared__ __align__(16) float stage[kTable ? kThreads * kMaxCols : 4];
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const bool live = i < t;
  if (threadIdx.x < 16) mm[threadIdx.x] = m[threadIdx.x];
  float av[3 * kMaxChannels];
#pragma unroll
  for (int k = 0; k < 3 * kMaxChannels; ++k)
    av[k] = (kTable && live && k < 3 * a) ? attrs[k * (size_t)t + i] : 0.0f;
  __syncthreads();

  const float wf = (float)width, hf = (float)height;
  float xs[3], ys[3], zs[3], ws[3];
  bool near_ok = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float X = live ? cols[(3 * c) * (size_t)t + i] : 0.0f;
    float Y = live ? cols[(3 * c + 1) * (size_t)t + i] : 0.0f;
    float Z = live ? cols[(3 * c + 2) * (size_t)t + i] : 0.0f;
    float cc[4];
    sr::clip_coords(mm, X, Y, Z, cc);
    near_ok = near_ok && (cc[3] > near_eps);
    sr::to_screen(cc[0], cc[1], cc[2], cc[3], wf, hf, &xs[c], &ys[c],
                  &zs[c]);
    ws[c] = cc[3];
  }
  const sr::Setup su = sr::setup_columns(xs, ys, zs, width, height, near_ok,
                                         cull, ccw);
  const float a0 = su.a0, a1 = su.a1, a2 = su.a2;
  const float b0 = su.b0, b1 = su.b1, b2 = su.b2;
  const float c0 = su.c0, c1 = su.c1, c2 = su.c2;
  const float zx = su.zx, zy = su.zy, zc = su.zc;
  const float abs_d = su.abs_d, inv_area = su.inv_area;
  const bool valid = su.valid, safe = su.safe;

  const float row[24] = {a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc,
                         valid ? abs_d : 0.0f, inv_area, su.d, su.bx0,
                         su.by0, su.bx1, su.by1, valid ? 1.0f : 0.0f, ws[0],
                         ws[1], ws[2], safe ? 1.0f : 0.0f};
  if (live) {
#pragma unroll
    for (int r = 0; r < 24; ++r) out[r * (size_t)t + i] = row[r];
  }
  if (!kTable) return;

  // The table row: stream_table_planar's columns, then per channel the
  // planes ((a0 v1 + a1 v2) + a2 v3) * inv_area (x, y, const); invalid
  // triangles get the poison row. Perspective: the corner values times
  // 1 / (w == 0 ? 1 : w), then the channel of those reciprocals.
  const int na = a + kPersp;
  const int ncols = kRec + 3 * na;
  float iw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) iw[c] = 1.0f / (ws[c] == 0.0f ? 1.0f : ws[c]);
  float* r = stage + threadIdx.x * ncols;
  if (live && valid) {
    const float head[kRec] = {a0, a1, b0, b1, c0, c1, abs_d, zx, zy, zc,
                              (float)i};
#pragma unroll
    for (int k = 0; k < kRec; ++k) r[k] = head[k];
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < na) {
        float v1 = av[3 * ch], v2 = av[3 * ch + 1], v3 = av[3 * ch + 2];
        if (kPersp && ch == a) {
          v1 = iw[0];
          v2 = iw[1];
          v3 = iw[2];
        } else if (kPersp) {
          v1 = v1 * iw[0];
          v2 = v2 * iw[1];
          v3 = v3 * iw[2];
        }
        r[kRec + 3 * ch] = ((a0 * v1 + a1 * v2) + a2 * v3) * inv_area;
        r[kRec + 3 * ch + 1] = ((b0 * v1 + b1 * v2) + b2 * v3) * inv_area;
        r[kRec + 3 * ch + 2] = ((c0 * v1 + c1 * v2) + c2 * v3) * inv_area;
      }
    }
  } else if (live) {
    for (int k = 0; k < ncols; ++k) r[k] = 0.0f;
    r[4] = -1.0f;       // c0 = c1 = -1: outside everywhere
    r[5] = -1.0f;
    r[9] = INFINITY;    // zc
    r[10] = -1.0f;      // id
  }
  __syncthreads();
  // The block's rows are one contiguous slice of the table, starting at a
  // multiple of kThreads * 4 bytes: store it in 16-byte chunks.
  const int n = min(kThreads, t - first) * ncols;
  float* dst = table + (size_t)first * ncols;
  const float4* src4 = reinterpret_cast<const float4*>(stage);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < n / 4; k += kThreads) dst4[k] = src4[k];
  for (int k = (n / 4) * 4 + threadIdx.x; k < n; k += kThreads)
    dst[k] = stage[k];
}

}  // namespace

// attrs: [3a, t] corner-attribute columns, read only with a table; table:
// [t, 11 + 3 (a + persp)] float32, 16-byte aligned, or null for the rows
// alone (persp then 0).
extern "C" int sr_fe(const float* cols, int t, const float* m,
                     const float* attrs, int a, int persp, int width,
                     int height, int cull, int ccw, float near_eps,
                     float* out, float* table, void* stream) {
  if (t < 0 || a < 0 || (persp && !table) || a + (persp ? 1 : 0) >
      kMaxChannels)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((t + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (table && persp)
    fe_kernel<true, true><<<blocks, kThreads, 0, s>>>(
        cols, t, m, attrs, a, width, height, cull, ccw, near_eps, out, table);
  else if (table)
    fe_kernel<true, false><<<blocks, kThreads, 0, s>>>(
        cols, t, m, attrs, a, width, height, cull, ccw, near_eps, out, table);
  else
    fe_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        cols, t, m, attrs, 0, width, height, cull, ccw, near_eps, out, table);
  return (int)cudaGetLastError();
}
