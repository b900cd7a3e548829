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
#include "common.cuh"

namespace {

__device__ __forceinline__ float round_half_away(float x) {
  return sr::tsign(x) * floorf(fabsf(x) + 0.5f);
}

__device__ __forceinline__ float clean(float a) {
  return isfinite(a) ? a : 0.0f;
}

__device__ __forceinline__ float clip(float a, float lo, float hi) {
  return sr::tmin(sr::tmax(a, lo), hi);
}

// ops/setup.py coverage_safe, expression for expression.
__device__ bool coverage_safe(float x1, float y1, float x2, float y2,
                              float x3, float y3, float a0, float b0,
                              float a1, float b1, float abs_d, float wf,
                              float hf) {
  const float tiny = 1e-30f;
  const float scale = 0x1p-20f;    // ERR_SCALE
  const float margin = 0.25f;      // SAFE_MARGIN
  float ax = sr::tmax(fabsf(x3), wf) + 1.0f;
  float ay = sr::tmax(fabsf(y3), hf) + 1.0f;
  float m0 = fabsf(a0) * ax + fabsf(b0) * ay;
  float m1 = fabsf(a1) * ax + fabsf(b1) * ay;
  float md = fabsf(x1 - x3) * fabsf(y2 - y3) + fabsf(x2 - x3) * fabsf(y1 - y3);
  bool exact = (m0 + m1 + md) < 0x1p21f;  // EXACT_LIMIT
  float err0 = exact ? 0.0f : m0 * scale;
  float err1 = exact ? 0.0f : m1 * scale;
  float err2 = err0 + err1 + (exact ? 0.0f : md * scale);
  float a2 = a0 + a1;
  float b2 = b0 + b1;
  float g0u = fabsf(a0) + fabsf(b0);
  float g1u = fabsf(a1) + fabsf(b1);
  float g2u = fabsf(a2) + fabsf(b2);
  float g0l = sr::tmax(sr::tmax(fabsf(a0), fabsf(b0)), tiny);
  float g1l = sr::tmax(sr::tmax(fabsf(a1), fabsf(b1)), tiny);
  float g2l = sr::tmax(sr::tmax(fabsf(a2), fabsf(b2)), tiny);
  float e_shift = sr::tmax(sr::tmax(err0 / g0l, err1 / g1l), err2 / g2l);
  float dd = sr::tmax(abs_d, tiny);
  float v_shift = sr::tmax(sr::tmax(err0 * g1u + err1 * g0u,
                                    err0 * g2u + err2 * g0u),
                           err1 * g2u + err2 * g1u) / dd;
  return (e_shift <= margin) && (v_shift <= margin);
}

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
    float cx = mm[0] * X + mm[1] * Y + mm[2] * Z + mm[3];
    float cy = mm[4] * X + mm[5] * Y + mm[6] * Z + mm[7];
    float cz = mm[8] * X + mm[9] * Y + mm[10] * Z + mm[11];
    float cw = mm[12] * X + mm[13] * Y + mm[14] * Z + mm[15];
    near_ok = near_ok && (cw > near_eps);
    float wg = (cw == 0.0f) ? 1.0f : cw;
    float u = (cx / wg) * 0.5f + 0.5f;
    float v = (cy / wg) * -0.5f + 0.5f;
    xs[c] = round_half_away(u * wf);
    ys[c] = round_half_away(v * hf);
    zs[c] = cz / wg;
    ws[c] = cw;
  }
  const float x1 = xs[0], x2 = xs[1], x3 = xs[2];
  const float y1 = ys[0], y2 = ys[1], y3 = ys[2];
  const float z1 = zs[0], z2 = zs[1], z3 = zs[2];

  float d = (x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3);
  bool finite = isfinite(x1) && isfinite(y1) && isfinite(z1) &&
                isfinite(x2) && isfinite(y2) && isfinite(z2) &&
                isfinite(x3) && isfinite(y3) && isfinite(z3);
  bool degenerate = !finite || (d == 0.0f);
  float s = (d < 0.0f) ? -1.0f : 1.0f;
  float abs_d = fabsf(d);
  float inv_area = degenerate ? 0.0f : 1.0f / abs_d;
  float a0 = (y2 - y3) * s;
  float b0 = (x3 - x2) * s;
  float a1 = (y3 - y1) * s;
  float b1 = (x1 - x3) * s;
  float c0 = -(a0 * x3 + b0 * y3);
  float c1 = -(a1 * x3 + b1 * y3);
  float a2 = -(a0 + a1);
  float b2 = -(b0 + b1);
  float c2 = abs_d - c0 - c1;
  float zx = (a0 * z1 + a1 * z2 + a2 * z3) * inv_area;
  float zy = (b0 * z1 + b1 * z2 + b2 * z3) * inv_area;
  float zc = (c0 * z1 + c1 * z2 + c2 * z3) * inv_area;

  float min_x = sr::tmin(sr::tmin(x1, x2), x3);
  float max_x = sr::tmax(sr::tmax(x1, x2), x3);
  float min_y = sr::tmin(sr::tmin(y1, y2), y3);
  float max_y = sr::tmax(sr::tmax(y1, y2), y3);
  bool offscreen = (max_x < 0.0f) || (min_x > wf) || (max_y < 0.0f) ||
                   (min_y > hf);
  float bx0 = clip(clean(floorf(min_x)), 0.0f, (float)(width - 1));
  float by0 = clip(clean(floorf(min_y)), 0.0f, (float)(height - 1));
  float bx1 = clip(clean(ceilf(max_x)), 0.0f, (float)(width - 1));
  float by1 = clip(clean(ceilf(max_y)), 0.0f, (float)(height - 1));

  bool valid = !degenerate && !offscreen && near_ok;
  if (cull) valid = valid && (ccw ? (d > 0.0f) : (d < 0.0f));

  a0 = valid ? a0 : 0.0f;
  a1 = valid ? a1 : 0.0f;
  a2 = valid ? a2 : 0.0f;
  b0 = valid ? b0 : 0.0f;
  b1 = valid ? b1 : 0.0f;
  b2 = valid ? b2 : 0.0f;
  c0 = valid ? c0 : -1.0f;
  c1 = valid ? c1 : -1.0f;
  c2 = valid ? c2 : -1.0f;
  zx = valid ? zx : 0.0f;
  zy = valid ? zy : 0.0f;
  zc = valid ? zc : INFINITY;
  inv_area = valid ? inv_area : 0.0f;
  bool safe = coverage_safe(x1, y1, x2, y2, x3, y3, a0, b0, a1, b1, abs_d,
                            wf, hf) || !valid;

  const float row[24] = {a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc,
                         valid ? abs_d : 0.0f, inv_area, d, bx0, by0, bx1,
                         by1, valid ? 1.0f : 0.0f, ws[0], ws[1], ws[2],
                         safe ? 1.0f : 0.0f};
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
