// The per-triangle front-end math that K1 (fe.cu) and the clip front-end
// (clip_front.cu) share: the vertex transform, the divide into pixel
// coordinates and the triangle setup. Plain versions: ops/vertex.py
// (clip_coords, ndc_to_screen) and ops/setup.py (setup_columns,
// coverage_safe); every expression is theirs, in their order, so with the
// library's --fmad=false both kernels round as the torch operations do.
#pragma once

#include "common.cuh"

namespace sr {

__device__ __forceinline__ float round_half_away(float x) {
  return tsign(x) * floorf(fabsf(x) + 0.5f);
}

__device__ __forceinline__ float clean(float a) {
  return isfinite(a) ? a : 0.0f;
}

__device__ __forceinline__ float clip(float a, float lo, float hi) {
  return tmin(tmax(a, lo), hi);
}

// ops/vertex.py clip_coords: row i of the row-major transform ``mm``
// as m[i,0] * X + m[i,1] * Y + m[i,2] * Z + m[i,3], for x, y, z, w.
__device__ __forceinline__ void clip_coords(const float* mm, float X, float Y,
                                            float Z, float c[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    c[r] = mm[4 * r] * X + mm[4 * r + 1] * Y + mm[4 * r + 2] * Z +
           mm[4 * r + 3];
}

// The divide by w (1 where w is 0) and ops/vertex.py ndc_to_screen: the
// rounded pixel x and y and the NDC z of one clip-space corner.
__device__ __forceinline__ void to_screen(float cx, float cy, float cz,
                                          float cw, float wf, float hf,
                                          float* x, float* y, float* z) {
  float wg = (cw == 0.0f) ? 1.0f : cw;
  float u = (cx / wg) * 0.5f + 0.5f;
  float v = (cy / wg) * -0.5f + 0.5f;
  *x = round_half_away(u * wf);
  *y = round_half_away(v * hf);
  *z = cz / wg;
}

// ops/setup.py coverage_safe, expression for expression.
__device__ inline bool coverage_safe(float x1, float y1, float x2, float y2,
                                     float x3, float y3, float a0, float b0,
                                     float a1, float b1, float abs_d,
                                     float wf, float hf) {
  const float tiny = 1e-30f;
  const float scale = 0x1p-20f;    // ERR_SCALE
  const float margin = 0.25f;      // SAFE_MARGIN
  float ax = tmax(fabsf(x3), wf) + 1.0f;
  float ay = tmax(fabsf(y3), hf) + 1.0f;
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
  float g0l = tmax(tmax(fabsf(a0), fabsf(b0)), tiny);
  float g1l = tmax(tmax(fabsf(a1), fabsf(b1)), tiny);
  float g2l = tmax(tmax(fabsf(a2), fabsf(b2)), tiny);
  float e_shift = tmax(tmax(err0 / g0l, err1 / g1l), err2 / g2l);
  float dd = tmax(abs_d, tiny);
  float v_shift = tmax(tmax(err0 * g1u + err1 * g0u,
                            err0 * g2u + err2 * g0u),
                       err1 * g2u + err2 * g1u) / dd;
  return (e_shift <= margin) && (v_shift <= margin);
}

// One triangle's setup: ops/setup.py setup_columns' outputs. abs_d is
// |D| before the valid mask; the edge, depth and inv_area values are
// masked (0, or -1 for the constants and +inf for zc, where invalid).
struct Setup {
  float a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc, abs_d, inv_area, d;
  float bx0, by0, bx1, by1;
  bool valid, safe;
};

// ops/setup.py setup_columns of the rounded pixel corners (xs, ys) and
// NDC depths zs; extra_valid is ANDed into validity.
__device__ __forceinline__ Setup setup_columns(const float xs[3],
                                               const float ys[3],
                                               const float zs[3], int width,
                                               int height, bool extra_valid,
                                               int cull, int ccw) {
  const float wf = (float)width, hf = (float)height;
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

  float min_x = tmin(tmin(x1, x2), x3);
  float max_x = tmax(tmax(x1, x2), x3);
  float min_y = tmin(tmin(y1, y2), y3);
  float max_y = tmax(tmax(y1, y2), y3);
  bool offscreen = (max_x < 0.0f) || (min_x > wf) || (max_y < 0.0f) ||
                   (min_y > hf);
  float bx0 = clip(clean(floorf(min_x)), 0.0f, (float)(width - 1));
  float by0 = clip(clean(floorf(min_y)), 0.0f, (float)(height - 1));
  float bx1 = clip(clean(ceilf(max_x)), 0.0f, (float)(width - 1));
  float by1 = clip(clean(ceilf(max_y)), 0.0f, (float)(height - 1));

  bool valid = !degenerate && !offscreen && extra_valid;
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
  return Setup{a0, a1, a2, b0, b1, b2, c0, c1, c2, zx, zy, zc, abs_d,
               inv_area, d, bx0, by0, bx1, by1, valid, safe};
}

}  // namespace sr
