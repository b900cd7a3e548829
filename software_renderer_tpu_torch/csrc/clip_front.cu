// The clip front-end: the corner and attribute gathers, the vertex
// transform, the near-plane clip of each triangle into two slots, the
// divide into pixel coordinates, the triangle setup of both slots and
// their [2T, 11 + 3A] stream table, in one pass. The JAX package runs this
// chain as XLA (software_renderer_tpu/render.py's clip_near branch); its
// plain version here is ops/clip.py clip_front_table_plain, the torch
// chain of transform_corners_clip, clip_near, compose_attrs, the divide,
// ndc_to_screen, setup_columns, perspective_vertex_attrs, from_setup and
// stream_table_planar, whose operations this kernel repeats in their
// order.
//
// The torch chain is ~500 small operations a frame, each a node of the
// replayed graph, and its concatenations and stacks move [2T, 3, *]
// intermediates through memory. Here each source triangle's thread reads
// its three indices, gathers its corners and attribute values itself and
// writes its two slots once.
//
// Bound: memory. Per source triangle 12 bytes of indices, 36 of corners
// and 12 A of attribute values in; per slot 72 bytes of float rows, 18 of
// bbox and flags and 44 + 12 (A + persp) of table out (~66 MB at 100k
// triangles and A = 8 + 1/w). Design:
// * One thread per source triangle t writes slot t and slot T + t, the
//   second triangle of a clipped quad (valid only where the case makes a
//   quad, ops/clip.py _TRI2_VALID).
// * The cuts are computed only for a triangle with a corner behind the
//   near plane (case 0, in front, needs none); the quad table picks the
//   corners by selects, so nothing leaves registers.
// * 128-thread blocks; the transform and the normal matrix are read once
//   per block into shared memory.
// * The setup rows, bbox and flags are [R, 2T] rows, stored coalesced by
//   slot. Each block stages the table rows of its slots t in shared
//   memory, then stores two contiguous slices of the table, [first, first
//   + 128) and [T + first, ...), in 16-byte chunks (the second slice may
//   start off a 16-byte boundary: single floats up to it).
// * A is a runtime count up to kMaxChannels, over at most three vertex
//   arrays; the one with the normals is rotated by the normal matrix as
//   it is gathered.
#include "setup.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChannels = 9;
constexpr int kMaxSources = 3;
constexpr int kRec = 11;  // a0 a1 b0 b1 c0 c1 |D| zx zy zc id
constexpr int kMaxCols = kRec + 3 * kMaxChannels;
// Float rows: a0 a1 a2 b0 b1 b2 c0 c1 c2 zx zy zc |D| 1/|D| D w1 w2 w3.
constexpr int kRows = 18;

// The per-vertex attribute arrays, in channel order: p[s] is [N, k[s]]
// float32; rot is the array rotated by the normal matrix (k = 3), or -1.
struct Sources {
  const float* p[kMaxSources];
  int k[kMaxSources];
  int rot;
};

__host__ __device__ constexpr unsigned pack(unsigned a, unsigned b,
                                            unsigned c, unsigned d) {
  return a | (b << 3) | (c << 6) | (d << 9);
}

// ops/clip.py _QUAD_LUT: per behind-mask case the four quad corners, 3
// bits each: candidates 0-2 the source corners, 3-5 the cuts of edges
// (0, 1), (1, 2) and (2, 0).
__device__ __forceinline__ unsigned quad_of(int cs) {
  switch (cs) {
    case 0: return pack(0, 1, 2, 2);
    case 1: return pack(5, 3, 1, 2);
    case 2: return pack(0, 3, 4, 2);
    case 3: return pack(5, 4, 2, 2);
    case 4: return pack(5, 0, 1, 4);
    case 5: return pack(3, 1, 4, 4);
    case 6: return pack(5, 0, 3, 3);
    default: return pack(0, 0, 0, 0);
  }
}

// Store n floats from shared memory (16-byte aligned) to global memory
// with the whole block: single floats up to dst's first 16-byte boundary,
// 16-byte chunks, then the rest.
__device__ __forceinline__ void store_block(float* __restrict__ dst,
                                            const float* src, int n) {
  const int head = min(
      n, (int)(((16 - (reinterpret_cast<size_t>(dst) & 15)) & 15) / 4));
  for (int k = threadIdx.x; k < head; k += kThreads) dst[k] = src[k];
  const int body = (n - head) / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  if (head == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; k < body; k += kThreads) dst4[k] = src4[k];
  } else {
    for (int k = threadIdx.x; k < body; k += kThreads) {
      const float* s = src + head + 4 * k;
      dst4[k] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  for (int k = head + 4 * body + threadIdx.x; k < n; k += kThreads)
    dst[k] = src[k];
}

// One thread per source triangle; kPersp: the channels over each corner's
// clip w, then a channel 1/w (a + 1 <= kMaxChannels).
template <bool kPersp>
__global__ void __launch_bounds__(kThreads)
clip_front_kernel(const int* __restrict__ idx, int t,
                  const float* __restrict__ pos, int n_vert, Sources src,
                  int a, const float* __restrict__ nm,
                  const float* __restrict__ m, int width, int height,
                  int cull, float eps, float* __restrict__ rows,
                  int* __restrict__ bbox, bool* __restrict__ flags,
                  float* __restrict__ table) {
  __shared__ float mm[16];
  __shared__ float nmat[9];
  __shared__ __align__(16) float stage[2 * kThreads * kMaxCols];
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const bool live = i < t;
  if (threadIdx.x < 16) mm[threadIdx.x] = m[threadIdx.x];
  if (nm != nullptr && threadIdx.x < 9) nmat[threadIdx.x] = nm[threadIdx.x];
  // An index outside the vertex arrays reads NaN (the triangle is then
  // invalid); a thread past T reads nothing.
  int vi[3];
  bool ok[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    vi[c] = live ? idx[3 * (size_t)i + c] : -1;
    ok[c] = vi[c] >= 0 && vi[c] < n_vert;
  }
  __syncthreads();

  // The attribute values at the source corners, av[3 ch + c]; the normals
  // as render.py shading_inputs rotates them, nm[j, 0] nx + nm[j, 1] ny +
  // nm[j, 2] nz.
  float av[3 * kMaxChannels];
  const int e0 = src.k[0], e1 = e0 + src.k[1];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    const int s = ch < e0 ? 0 : (ch < e1 ? 1 : 2);
    const float* p = s == 0 ? src.p[0] : (s == 1 ? src.p[1] : src.p[2]);
    const int k = s == 0 ? src.k[0] : (s == 1 ? src.k[1] : src.k[2]);
    const int j = ch - (s == 0 ? 0 : (s == 1 ? e0 : e1));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = 0.0f;
      if (ch < a) {
        if (!ok[c]) {
          v = sr::qnan();
        } else if (s == src.rot) {
          const float* n = p + 3 * (size_t)vi[c];
          v = nmat[3 * j] * n[0] + nmat[3 * j + 1] * n[1] +
              nmat[3 * j + 2] * n[2];
        } else {
          v = p[(size_t)vi[c] * k + j];
        }
      }
      av[3 * ch + c] = v;
    }
  }

  // ops/clip.py transform_corners_clip, then clip_near's case and cuts.
  float P[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float X = sr::qnan(), Y = sr::qnan(), Z = sr::qnan();
    if (ok[c]) {
      const float* q = pos + 3 * (size_t)vi[c];
      X = q[0];
      Y = q[1];
      Z = q[2];
    }
    sr::clip_coords(mm, X, Y, Z, P[c]);
  }
  const int cs = (P[0][3] < eps) + 2 * (P[1][3] < eps) + 4 * (P[2][3] < eps);
  // Cut e on edge (e, e + 1 mod 3): s = (eps - w_a) / (w_b - w_a), 1 in
  // place of a zero denominator; P = P_a + s (P_b - P_a).
  float C[3][4], S[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    S[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) C[e][k] = 0.0f;
  }
  if (cs != 0) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int ea = e, eb = (e + 1) % 3;
      const float den = P[eb][3] - P[ea][3];
      const float s = (eps - P[ea][3]) / (fabsf(den) > 0.0f ? den : 1.0f);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        C[e][k] = P[ea][k] + s * (P[eb][k] - P[ea][k]);
      S[e] = s;
    }
  }
  // The quad's corners and their barycentric weights over the source
  // corners: a source corner's unit row; a cut's 1 - s at its edge's first
  // corner, s at its second.
  const unsigned code = quad_of(cs);
  float Q[4][4], QB[4][3];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = (code >> (3 * q)) & 7;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      Q[q][r] = k == 0 ? P[0][r] : k == 1 ? P[1][r] : k == 2 ? P[2][r]
              : k == 3 ? C[0][r] : k == 4 ? C[1][r] : C[2][r];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float b = k == j ? 1.0f : 0.0f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        if (k == 3 + e && j == e) b = 1.0f - S[e];
        if (k == 3 + e && j == (e + 1) % 3) b = S[e];
      }
      QB[q][j] = b;
    }
  }

  const float wf = (float)width, hf = (float)height;
  const size_t t2 = 2 * (size_t)t;
  const int na = a + kPersp;
  const int ncols = kRec + 3 * na;
  // Slot t: corners (0, 1, 2) of the quad, valid unless every corner is
  // behind; slot T + t: corners (0, 2, 3), valid where the case makes a
  // quad (cases 1, 2 and 4).
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int qi[3] = {0, sl ? 2 : 1, sl ? 3 : 2};
    const bool cvalid = sl ? (cs == 1 || cs == 2 || cs == 4) : (cs != 7);
    float xs[3], ys[3], zs[3], iw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* q = Q[qi[c]];
      sr::to_screen(q[0], q[1], q[2], q[3], wf, hf, &xs[c], &ys[c], &zs[c]);
      iw[c] = 1.0f / (q[3] == 0.0f ? 1.0f : q[3]);
    }
    const sr::Setup su = sr::setup_columns(xs, ys, zs, width, height, cvalid,
                                           cull, 1);
    const size_t o = sl ? (size_t)t + i : (size_t)i;
    if (live) {
      const float nan = sr::qnan();  // from_setup: no clip w on a slot
      const float row[kRows] = {su.a0, su.a1, su.a2, su.b0, su.b1, su.b2,
                                su.c0, su.c1, su.c2, su.zx, su.zy, su.zc,
                                su.valid ? su.abs_d : 0.0f, su.inv_area,
                                su.d, nan, nan, nan};
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r * t2 + o] = row[r];
      bbox[o] = (int)su.bx0;
      bbox[t2 + o] = (int)su.by0;
      bbox[2 * t2 + o] = (int)su.bx1;
      bbox[3 * t2 + o] = (int)su.by1;
      flags[o] = su.valid;
      flags[t2 + o] = su.safe;
    }

    // The table row: stream_table_planar's columns, then per channel the
    // planes ((a0 v1 + a1 v2) + a2 v3) * inv_area (x, y, const) of the
    // corner values through the clip, compose_attrs' (b0 s0 + b1 s1) +
    // b2 s2 of the source values s; perspective: those times 1 / w, then
    // the channel of the reciprocals. Invalid slots get the poison row.
    float* r = stage + (sl * kThreads + threadIdx.x) * ncols;
    if (live && su.valid) {
      const float head[kRec] = {su.a0, su.a1, su.b0, su.b1, su.c0, su.c1,
                                su.abs_d, su.zx, su.zy, su.zc, (float)o};
#pragma unroll
      for (int k = 0; k < kRec; ++k) r[k] = head[k];
#pragma unroll
      for (int ch = 0; ch < kMaxChannels; ++ch) {
        if (ch < na) {
          float v[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* b = QB[qi[c]];
            if (kPersp && ch == a) {
              v[c] = iw[c];
            } else {
              v[c] = (b[0] * av[3 * ch] + b[1] * av[3 * ch + 1]) +
                     b[2] * av[3 * ch + 2];
              if (kPersp) v[c] = v[c] * iw[c];
            }
          }
          r[kRec + 3 * ch] =
              ((su.a0 * v[0] + su.a1 * v[1]) + su.a2 * v[2]) * su.inv_area;
          r[kRec + 3 * ch + 1] =
              ((su.b0 * v[0] + su.b1 * v[1]) + su.b2 * v[2]) * su.inv_area;
          r[kRec + 3 * ch + 2] =
              ((su.c0 * v[0] + su.c1 * v[1]) + su.c2 * v[2]) * su.inv_area;
        }
      }
    } else if (live) {
      for (int k = 0; k < ncols; ++k) r[k] = 0.0f;
      r[4] = -1.0f;       // c0 = c1 = -1: outside everywhere
      r[5] = -1.0f;
      r[9] = INFINITY;    // zc
      r[10] = -1.0f;      // id
    }
  }
  __syncthreads();
  const int n = min(kThreads, t - first) * ncols;
  store_block(table + (size_t)first * ncols, stage, n);
  store_block(table + ((size_t)t + first) * ncols, stage + kThreads * ncols,
              n);
}

}  // namespace

// idx: [3t] int32 vertex indices; pos: [n_vert, 3]; src0-2: [n_vert, k]
// attribute arrays in channel order (k = 0: none), src<rot> rotated by the
// row-major 3x3 nm (rot -1: none); m: the row-major 4x4 transform. Writes
// rows [18, 2t] float32, bbox [4, 2t] int32, flags [2, 2t] bool (valid,
// safe) and table [2t, 11 + 3 (a + persp)] float32, a = k0 + k1 + k2.
extern "C" int sr_clip_front(const int* idx, int t, const float* pos,
                             int n_vert, const float* src0, int k0,
                             const float* src1, int k1, const float* src2,
                             int k2, int rot, const float* nm, int persp,
                             const float* m, int width, int height, int cull,
                             float eps, float* rows, int* bbox, void* flags,
                             float* table, void* stream) {
  const int a = k0 + k1 + k2;
  const int ks[kMaxSources] = {k0, k1, k2};
  if (t < 0 || t > (1 << 29) || n_vert < 0 || k0 < 0 || k1 < 0 || k2 < 0 ||
      a + (persp ? 1 : 0) > kMaxChannels || (persp && a == 0) || rot < -1 ||
      rot >= kMaxSources || (rot >= 0 && (ks[rot] != 3 || !nm)))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const Sources src{{src0, src1, src2}, {k0, k1, k2}, rot};
  const unsigned blocks = (unsigned)((t + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  bool* fl = static_cast<bool*>(flags);
  if (persp)
    clip_front_kernel<true><<<blocks, kThreads, 0, s>>>(
        idx, t, pos, n_vert, src, a, nm, m, width, height, cull, eps, rows,
        bbox, fl, table);
  else
    clip_front_kernel<false><<<blocks, kThreads, 0, s>>>(
        idx, t, pos, n_vert, src, a, nm, m, width, height, cull, eps, rows,
        bbox, fl, table);
  return (int)cudaGetLastError();
}
