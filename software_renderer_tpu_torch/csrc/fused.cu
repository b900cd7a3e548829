// The binned record walk, as two instances of one template:
//
//   fused raster + shade (K2), entry sr_fused: visibility, the winners'
//     attribute planes and the shading epilogue in one pass, static or
//     seeded. Replaces the TPU kernel _fused_kernel
//     (software_renderer_tpu/ops/binning.py:703) in both variants; plain
//     version fused_plain in software_renderer_tpu_torch/ops/binning.py,
//     the epilogue's fused_epilogue in ops/shading.py;
//   binned visibility (K5), entry sr_binned_vis: the zero-channel instance
//     with no epilogue. Replaces _binned_vis_kernel (:607); plain version
//     binned_vis_plain.
//
// Layout: the records of bin b (one (tile, band) slab of 128 columns) are
// rows bin_start[b] .. bin_start[b+1] of `rows`, in ascending triangle id;
// column 10 holds the id, which indexes `bbox`, the planar setup's
// inclusive int32 pixel bbox (x0, y0, x1, y1, absolute rows). Binned
// triangles are coverage-safe (ops/setup.py coverage_safe): no pixel of
// the frame outside its bbox passes a record's edge test. So a pixel need
// only be tested against the records whose bbox holds it, and the walk
// skips the rest with no change to any pixel.
//
// What bounds it: the (pixel, record) tests, and at config 4 the few long
// bins (records per bin p50 0, max 782 for K2 and 1,786 for K5, whose
// bins are whole 64 x 128 tiles). A bin's band is 16 x 128 pixels and a
// config-4 triangle's bbox about 6 x 6, so the previous design, which
// tested every record on every pixel of its band, did ~50x the tests the
// data needs. Here one block of kThreads threads covers a kSlabH-row slab
// of one bin, and each warp a kRectW x kRectH rectangle of it, kPix pixels
// a lane in registers. The block stages kChunk records at a time in
// shared memory, one a thread, with each record's bbox clipped to the slab
// (one 32-bit word; empty for poison rows, id -1). Each warp then culls the
// chunk 32 records at a time with one bbox test a lane and __ballot_sync,
// and walks the survivors in list order, testing only the rows of lanes of
// its rectangle that the bbox spans. Small rectangles keep the serial walk
// of a warp in a long bin short: sweep_binned.py put 16 x 4 rectangles in
// 8-row slabs first for K5 and within 4% of the first (8 x 8) for K2, and
// 32 x 16 ones in 16-row slabs last (4x slower). Order is kept without
// atomics, so the strict < (first drawn wins ties) and the seeded lex
// (depth, id) rule hold as in the plain versions.
//
// The spill branch is made on the device. JAX chooses between the static
// and the seeded kernel with lax.cond(n_overflow == 0, ...)
// (software_renderer_tpu/ops/binning.py:1471); here a seeded launch may
// be given the overflow count n_seed, a device pointer, and every block
// reads it and runs the static walk when it is 0: the same instructions
// as a static launch, reading no seed, so a spill-free frame is the static
// walk's bit for bit, and the count never reaches the host.
//
// The walk keeps no attribute accumulators: a pixel keeps its depth, id
// and the row of the record that won it, and the epilogue evaluates the
// winner's planes, reading them from that row (or the seed G-buffer where
// the seed won). The values are those the plain version computes when the
// record wins. Every pixel of every bin is written, empty bins included.
//
// The epilogue is a template over the four output plans of
// fused_output_channels (kLit: lighting from a normal channel; kTex: uv
// passed on to the texture tail), so each plan compiles to straight-line
// code with a fixed number of output planes, and over kPersp, the
// perspective plan (JAX's _fused_kernel with perspective_epilogue,
// software_renderer_tpu/ops/shading.py:271; plain version
// perspective_epilogue in ops/shading.py): the records then carry the
// plan's channels over w and a last 1/w channel, and on a covered pixel the
// epilogue takes rec = 1 / (1/w at the pixel centre, from the winner's row
// or the seed G-buffer) once and reads every channel as ch * rec; an
// uncovered pixel divides by 1 and is zeroed. A covered pixel's 1/w is
// > 0 (every corner of a drawn triangle has w > 0 after the near-plane cull
// or clip), so rec is finite.
#include "common.cuh"

namespace {

// Block shape, swept on the card by software_renderer_tpu_torch/tools/
// sweep_binned.py: rows per block (a band must be a multiple), columns of
// a warp rectangle, pixels per thread, and the resident blocks per SM
// asked of ptxas. Lane l of a warp owns column l % kRectW of its
// rectangle and rows l / kRectW + kLaneRows * i, i < kPix.
constexpr int kSlabH = 8;
constexpr int kRectW = 16;
constexpr int kPix = 2;
constexpr int kMinBlocks = 2;
constexpr int kLaneRows = 32 / kRectW;       // rows of lanes in a rectangle
constexpr int kRectH = kLaneRows * kPix;     // rows of a warp rectangle
constexpr int kWarpsX = sr::kTileW / kRectW;
constexpr int kWarps = kWarpsX * (kSlabH / kRectH);
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 11;  // record columns the walk reads
// Records staged per pass, one a thread (at most 512: static shared
// memory stays under 48 KB).
constexpr int kChunk = kThreads < 512 ? kThreads : 512;
static_assert(32 % kRectW == 0 && kSlabH % kRectH == 0 && kThreads <= 1024,
              "block shape");
static_assert(kSlabH <= 255, "slab rows fit a box byte");

// A record's bbox clipped to the slab, slab-relative and inclusive, as
// x0 | x1 << 8 | y0 << 16 | y1 << 24; kEmpty meets no warp rectangle.
constexpr unsigned kEmpty = 0xffu | (0xffu << 16);

// Channels of a perspective plan: the largest plan's 8 (rgb, normal, uv)
// and 1/w.
constexpr int kMaxPerspChannels = 9;

// Output planes of each plan:
//   kLit && kTex: lit rgb, spec, u, v    kLit && !kTex: final rgb
//   !kLit && kTex: rgb, u, v             !kLit && !kTex: rgb
template <bool kLit, bool kTex>
constexpr int kNOut = 3 + (kLit && kTex) + 2 * kTex;

struct WalkArgs {
  const float* rows;     // [n_pairs, wtot] records in bin order
  int wtot;              // 11 + 3 * n_channels (K2), >= 11 (K5)
  const int* bin_start;  // [nbins + 1] CSR offsets
  const int4* bbox;      // [n_tri] x0, y0, x1, y1 (inclusive, absolute rows)
  int n_tri;
  int width, height, y_start, tile_h, bands, gw;
  // K2 only.
  const float* params;   // [32] shading row
  int rgb_off, nrm_off, uv_off;  // channel offsets, -1 where absent
  int invw_off;          // perspective plan: the 1/w channel (the last)
  const float* z_seed;   // seeded only: [H, W]
  const int* id_seed;    // seeded only: [H, W]
  const float* gb_seed;  // seeded only: [n_channels, H, W]
  const int* n_seed;     // seeded only: the overflow count, or null (seed)
  float* z_out;          // [H, W]
  int* id_out;           // [H, W]
  float* out;            // K2: [kNOut, H, W]
};

// The slab-relative box of record id `tri` in the slab whose top-left
// pixel is (sx0, global row gy0). Ids outside the table get the whole slab
// (no cull).
__device__ __forceinline__ unsigned slab_box(int tri, const WalkArgs& g,
                                             int sx0, int gy0) {
  if (tri < 0) return kEmpty;  // poison row: covers nothing
  int x0 = 0, x1 = sr::kTileW - 1, y0 = 0, y1 = kSlabH - 1;
  if (tri < g.n_tri) {
    const int4 bb = __ldg(g.bbox + tri);
    x0 = max(bb.x - sx0, 0);
    x1 = min(bb.z - sx0, sr::kTileW - 1);
    y0 = max(bb.y - gy0, 0);
    y1 = min(bb.w - gy0, kSlabH - 1);
    if (x0 > x1 || y0 > y1) return kEmpty;
  }
  return (unsigned)x0 | (unsigned)x1 << 8 | (unsigned)y0 << 16 |
         (unsigned)y1 << 24;
}

// Whether a box meets the warp rectangle at slab columns wx .. wx +
// kRectW - 1, rows wy .. wy + kRectH - 1.
__device__ __forceinline__ bool meets(unsigned box, int wx, int wy) {
  const int x0 = box & 0xff, x1 = (box >> 8) & 0xff, y0 = (box >> 16) & 0xff,
            y1 = box >> 24;
  return x0 <= wx + kRectW - 1 && x1 >= wx && y0 <= wy + kRectH - 1 &&
         y1 >= wy;
}

// Channel a of a pixel: the winning row's plane at the pixel centre, else
// the seed G-buffer's value where the seed's id won the pixel (seeded),
// else 0. An uncovered pixel's channels are zeroed by the epilogue, so
// the seed G-buffer is read only where the seed won (the overflow
// resolve writes only those pixels).
template <bool kSeeded>
__device__ __forceinline__ float chan(int a, int row, bool covered, size_t p,
                                      size_t npix, float xs, float ys,
                                      const WalkArgs& g) {
  if (row >= 0) {
    const float* r = g.rows + (size_t)row * g.wtot + kCols + 3 * a;
    return __ldg(r) * xs + __ldg(r + 1) * ys + __ldg(r + 2);
  }
  return (kSeeded && covered) ? g.gb_seed[a * npix + p] : 0.0f;
}

// fused_epilogue (inside perspective_epilogue with kPersp) for one pixel;
// writes kNOut<kLit, kTex> planes to outs.
template <bool kSeeded, bool kLit, bool kTex, bool kPersp>
__device__ __forceinline__ void epilogue(int row, size_t p, size_t npix,
                                         float xs, float ys, bool covered,
                                         const float* __restrict__ prm,
                                         const WalkArgs& g, float* outs) {
  float rec = 1.0f;
  if constexpr (kPersp) {
    const float invw =
        chan<kSeeded>(g.invw_off, row, covered, p, npix, xs, ys, g);
    rec = 1.0f / (covered ? invw : 1.0f);
  }
  auto ch = [&](int a) {
    const float v = chan<kSeeded>(a, row, covered, p, npix, xs, ys, g);
    return kPersp ? v * rec : v;
  };
  float base[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    base[c] = g.rgb_off >= 0 ? ch(g.rgb_off + c) : prm[16 + c] * 1.0f;
  int n = 0;
  if constexpr (kLit) {
    const float n0 = ch(g.nrm_off), n1 = ch(g.nrm_off + 1),
                n2 = ch(g.nrm_off + 2);
    float inv = 1.0f / sqrtf(sr::tmax(n0 * n0 + n1 * n1 + n2 * n2, 1e-12f));
    float nx = n0 * inv, ny = n1 * inv, nz = n2 * inv;
    float ndotl = sr::tmax(nx * prm[0] + ny * prm[1] + nz * prm[2], 0.0f);
    float ndoth = sr::tmax(nx * prm[3] + ny * prm[4] + nz * prm[5], 0.0f);
    float spec = powf(ndoth, prm[15]) * sr::tsign(ndotl);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float lit_c = base[c] * (prm[9 + c] + prm[6 + c] * ndotl);
      outs[n++] = kTex ? lit_c : lit_c + prm[12 + c] * spec;
    }
    if constexpr (kTex) outs[n++] = spec;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) outs[n++] = base[c];
  }
  if constexpr (kTex) {
    outs[n++] = ch(g.uv_off);
    outs[n++] = ch(g.uv_off + 1);
  }
#pragma unroll
  for (int k = 0; k < kNOut<kLit, kTex>; ++k)
    outs[k] = covered ? outs[k] : 0.0f;
}

// Shared memory of a walk block.
struct WalkShared {
  float srec[kCols][kChunk];
  unsigned sbox[kChunk];
  float prm[32];
};

// One block's walk of its slab. kShade: K2 (winner rows and the
// epilogue); else K5 (depth and id only).
template <bool kShade, bool kSeeded, bool kLit, bool kTex, bool kPersp>
__device__ __forceinline__ void walk(const WalkArgs& g, WalkShared& sh) {
  auto& srec = sh.srec;
  auto& sbox = sh.sbox;
  auto& prm = sh.prm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int band_h = g.tile_h / g.bands;
  const int tile = b / g.bands, band = b % g.bands;
  // The slab's top-left pixel (frame row sy0, global row sy0 + y_start)
  // and this warp's rectangle in the slab.
  const int sx0 = (tile % g.gw) * sr::kTileW;
  const int sy0 = (tile / g.gw) * g.tile_h + band * band_h +
                  blockIdx.y * kSlabH;
  const int wx = (warp % kWarpsX) * kRectW, wy = (warp / kWarpsX) * kRectH;
  const int x = sx0 + wx + lane % kRectW;
  const int y_first = sy0 + wy + lane / kRectW;
  const int width = g.width, height = g.height;
  const size_t npix = (size_t)width * height;
  const float xs = (float)x + 0.5f;

  if (kShade && tid < 32) prm[tid] = g.params[tid];

  float ys[kPix], z[kPix];
  int id[kPix], win[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int y = y_first + kLaneRows * i;
    ys[i] = (float)(y + g.y_start) + 0.5f;
    const bool in_frame = x < width && y < height;
    const size_t p = (size_t)y * width + x;
    z[i] = (kSeeded && in_frame) ? g.z_seed[p] : INFINITY;
    id[i] = (kSeeded && in_frame) ? g.id_seed[p] : -1;
    win[i] = -1;
  }

  const int start = g.bin_start[b], end = g.bin_start[b + 1];
  for (int base = start; base < end; base += kChunk) {
    const int cnt = min(kChunk, end - base);
    __syncthreads();  // the previous chunk is no longer read
    if (tid < kChunk) {
      unsigned box = kEmpty;
      if (tid < cnt) {
        const float* r = g.rows + (size_t)(base + tid) * g.wtot;
#pragma unroll
        for (int c = 0; c < kCols; ++c) srec[c][tid] = __ldg(r + c);
        box = slab_box((int)__ldg(r + 10), g, sx0, sy0 + g.y_start);
      }
      sbox[tid] = box;
    }
    __syncthreads();
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      const unsigned mine = sbox[k0 + lane];  // kEmpty past cnt
      unsigned m = __ballot_sync(0xffffffffu, meets(mine, wx, wy));
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const unsigned bj = __shfl_sync(0xffffffffu, mine, j);
        const int k = k0 + j;
        const int rlo = (int)((bj >> 16) & 0xff) - wy;
        const int rhi = (int)(bj >> 24) - wy;
        const float a0 = srec[0][k], a1 = srec[1][k], b0 = srec[2][k],
                    b1 = srec[3][k], c0 = srec[4][k], c1 = srec[5][k],
                    dabs = srec[6][k], zx = srec[7][k], zy = srec[8][k],
                    zc = srec[9][k];
        const int tri = (int)srec[10][k];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          // Skip the pixels whose row of lanes the bbox misses.
          if (kLaneRows * (i + 1) - 1 < rlo || kLaneRows * i > rhi) continue;
          float e0 = a0 * xs + b0 * ys[i] + c0;
          float e1 = a1 * xs + b1 * ys[i] + c1;
          float e2 = dabs - e0 - e1;
          bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
          float depth = zx * xs + zy * ys[i] + zc;
          float cand = inside ? depth : INFINITY;
          bool better = cand < z[i];
          if constexpr (kSeeded)
            better = better || (inside && cand == z[i] && tri < id[i]);
          if (better) {
            z[i] = cand;
            id[i] = tri;
            if constexpr (kShade) win[i] = base + k;
          }
        }
      }
    }
  }
  if (kShade && start == end) __syncthreads();  // prm is read below

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int y = y_first + kLaneRows * i;
    if (x >= width || y >= height) continue;
    const size_t p = (size_t)y * width + x;
    g.z_out[p] = z[i];
    g.id_out[p] = id[i];
    if constexpr (kShade) {
      float outs[kNOut<kLit, kTex>];
      epilogue<kSeeded, kLit, kTex, kPersp>(win[i], p, npix, xs, ys[i],
                                            id[i] >= 0, prm, g, outs);
#pragma unroll
      for (int c = 0; c < kNOut<kLit, kTex>; ++c)
        g.out[c * npix + p] = outs[c];
    }
  }
}

template <bool kShade, bool kSeeded, bool kLit, bool kTex, bool kPersp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    walk_kernel(const WalkArgs g) {
  __shared__ WalkShared sh;
  if constexpr (kSeeded) {
    // JAX's lax.cond(n_overflow == 0, static, seeded), per block.
    if (g.n_seed != nullptr && __ldg(g.n_seed) <= 0) {
      walk<kShade, false, kLit, kTex, kPersp>(g, sh);
      return;
    }
  }
  walk<kShade, kSeeded, kLit, kTex, kPersp>(g, sh);
}

template <bool kShade, bool kSeeded, bool kLit, bool kTex, bool kPersp>
int launch(int nbins, cudaStream_t s, const WalkArgs& g) {
  const dim3 grid(nbins, (g.tile_h / g.bands) / kSlabH);
  if (nbins > 0)
    walk_kernel<kShade, kSeeded, kLit, kTex, kPersp>
        <<<grid, kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

template <bool kSeeded, bool kPersp>
int launch_fused(bool lit, bool tex, int nbins, cudaStream_t s,
                 const WalkArgs& g) {
  if (lit && tex)
    return launch<true, kSeeded, true, true, kPersp>(nbins, s, g);
  if (lit) return launch<true, kSeeded, true, false, kPersp>(nbins, s, g);
  if (tex) return launch<true, kSeeded, false, true, kPersp>(nbins, s, g);
  return launch<true, kSeeded, false, false, kPersp>(nbins, s, g);
}

bool bad_grid(int tile_h, int bands, int n_tri) {
  return bands <= 0 || tile_h % bands || (tile_h / bands) % kSlabH ||
         n_tri < 0;
}

}  // namespace

extern "C" int sr_fused(const float* rows, const int* bin_start, int nbins,
                        const float* params, int wtot, const int* bbox,
                        int n_tri, int width, int height, int y_start,
                        int tile_h, int bands, int gw, int n_channels,
                        int rgb_off, int nrm_off, int uv_off, int lit, int tex,
                        int persp, const float* z_seed, const int* id_seed,
                        const float* gb_seed, const int* n_seed,
                        float* z_out, int* id_out, float* out,
                        void* stream) {
  // A perspective plan's channels are the inner plan's, then 1/w.
  const int inner = n_channels - (persp ? 1 : 0);
  const auto fits = [&](int off, int size) {
    return off < 0 || off + size <= inner;
  };
  if (wtot != kCols + 3 * n_channels || bad_grid(tile_h, bands, n_tri) ||
      inner < 0 || (persp && n_channels > kMaxPerspChannels) ||
      !fits(rgb_off, 3) || !fits(nrm_off, 3) || !fits(uv_off, 2) ||
      (lit && nrm_off < 0) || (tex && uv_off < 0))
    return (int)cudaErrorInvalidValue;
  const WalkArgs g{rows,    wtot,    bin_start, (const int4*)bbox,
                   n_tri,   width,   height,    y_start,
                   tile_h,  bands,   gw,        params,
                   rgb_off, nrm_off, uv_off,    inner,
                   z_seed,  id_seed, gb_seed,   n_seed,
                   z_out,   id_out,  out};
  const cudaStream_t s = (cudaStream_t)stream;
  if (persp)
    return z_seed ? launch_fused<true, true>(lit, tex, nbins, s, g)
                  : launch_fused<false, true>(lit, tex, nbins, s, g);
  return z_seed ? launch_fused<true, false>(lit, tex, nbins, s, g)
                : launch_fused<false, false>(lit, tex, nbins, s, g);
}

extern "C" int sr_binned_vis(const float* rows, int wtot, const int* bin_start,
                             int nbins, const int* bbox, int n_tri, int width,
                             int height, int y_start, int tile_h, int bands,
                             int gw, float* z_out, int* id_out, void* stream) {
  if (wtot < kCols || bad_grid(tile_h, bands, n_tri))
    return (int)cudaErrorInvalidValue;
  WalkArgs g{};
  g.rows = rows;
  g.wtot = wtot;
  g.bin_start = bin_start;
  g.bbox = (const int4*)bbox;
  g.n_tri = n_tri;
  g.width = width;
  g.height = height;
  g.y_start = y_start;
  g.tile_h = tile_h;
  g.bands = bands;
  g.gw = gw;
  g.z_out = z_out;
  g.id_out = id_out;
  return launch<false, false, false, false, false>(nbins,
                                                  (cudaStream_t)stream, g);
}
