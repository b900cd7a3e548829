// Record-walking visibility: rasterize raster records (coverage clamped to
// each record's bbox) into a (z, id) buffer. Replaces the TPU kernel
// _visibility_kernel (software_renderer_tpu/ops/rasterize_pallas.py:110) in
// both of its modes, as two instances of one template:
//
//   merge (kClear = false), entry sr_visibility_merge: start from the given
//     buffer and keep the lexicographic (depth, id) minimum, the overflow
//     pass of the binned paths; plain version visibility_merge_plain. The
//     records are a static list and a device count n_live (JAX's n_live,
//     rasterize_pallas.py:227) says how many are live: the span and
//     super-tile passes read it and skip the rest, so a frame with no
//     spill pays the launches and the copy of its seed, and no count
//     reaches the host;
//   clear (kClear = true), entry sr_visibility: start from (inf, -1) in
//     registers and replace only on a strictly smaller depth, walking the
//     records in the order given (ascending id: the first drawn wins ties),
//     the `pallas` backend; plain version visibility_plain. Both plain
//     versions live in software_renderer_tpu_torch/ops/rasterize_kernel.py.
//
// What bounds it: every block of pixels must learn which of the N records
// can touch it, and then test each such record on its pixels (about 24
// float operations per (pixel, record) pair). A block that scanned all N
// records would cost blocks x N reads through L2, more than the raster at
// config 4 (99,968 records, 1920x1080); a CSR list per tile built through
// a host sync and a sort costs more again. So the records are culled in
// two levels, in three launches and with no host sync:
//
//   1. span_kernel, one thread per record: the exact range of pixels
//      whose centres pass the record's bbox clamp, 8 bytes per record in
//      scratch (empty for the (1, 1, 0, 0) poison rows);
//   2. super_kernel, one block per (kChunk records, kSuperW x kSuperH
//      super-tile): the chunk's records whose span meets the super-tile,
//      in ascending order, into the chunk's own region of the super-tile's
//      N-entry list, and their count; no region can overflow, so nothing
//      waits for a total;
//   3. visibility_kernel, one block of 256 threads per kTileW x kTileH
//      tile, each thread holding kRows pixels of one column in registers
//      (a warp spans 32 columns and kRows rows). The block walks its
//      super-tile's chunks in order, kPerThread listed records per thread
//      a pass (their loads in flight together), keeps those whose span
//      meets the tile in a shared-memory list with __ballot_sync and a
//      warp-shuffle prefix sum (ascending order kept, one barrier a pass),
//      and drains the list whenever it may overflow and at the end: it
//      stages kStage records at a time in shared memory, and every warp
//      walks them in order, skipping a record whose span misses the
//      warp's 32 x kRows pixels and, inside it, the rows it misses.
//
// A pixel sees every record that can cover it, in the order given, with
// the per-pixel arithmetic of the plain versions (the bbox clamp included),
// so the culls change no pixel: the clear mode keeps its first-drawn tie
// rule, and the merge mode's lex minimum does not depend on the order.
#include "common.cuh"

namespace {

constexpr int kRec = 16;      // REC_WIDTH
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Spans are int16: frames up to kMaxCoord pixels a side (rows counted
// from row 0 of the whole frame, y_start included).
constexpr int kMaxCoord = 32767;
// Screen tile of one block, its super-tile, and the resident blocks per SM
// asked of ptxas, swept on the card by software_renderer_tpu_torch/tools/
// sweep_visibility.py.
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kSuperW = 256;
constexpr int kSuperH = 128;
constexpr int kMinBlocks = 2;
constexpr int kWarpsX = kTileW / 32;
constexpr int kWarpsY = kWarps / kWarpsX;
constexpr int kRows = kTileH / kWarpsY;  // pixels per thread
// A cull pass gives kPerThread records to each thread.
constexpr int kPerThread = 4;
constexpr int kPass = kThreads * kPerThread;
constexpr int kChunk = 4 * kPass;        // records per super_kernel block
// Survivor list: drained once it holds more than kCap - kPass records, so
// one pass always fits; the drain stages kStage records at a time.
constexpr int kCap = 2048;
constexpr int kStage = kThreads;
static_assert(kTileW % 32 == 0 && kWarps % kWarpsX == 0, "tile width");
static_assert(kTileH % kWarpsY == 0 && kRows >= 1, "tile height");
static_assert(kSuperW % kTileW == 0 && kSuperH % kTileH == 0, "super-tile");
static_assert(kCap >= 2 * kPass, "survivor list");
static_assert(kPerThread * kWarps == 32, "one count per lane in the scan");

// Pixels p of [a, b) whose centre p + 0.5 passes the per-pixel bbox clamp
// centre >= lo && centre <= hi + 1.0f (hi + 1.0f rounded in float, as the
// clamp rounds it), as the inclusive range [p0, p1]; false when none does
// (NaN bounds included). In double, where the centre arithmetic is exact.
__device__ __forceinline__ bool centre_range(float lo, float hi, int a, int b,
                                             int& p0, int& p1) {
  const double c0 = ceil((double)lo - 0.5);
  const double c1 = floor((double)(hi + 1.0f) - 0.5);
  if (!(c0 <= c1 && c0 < (double)b && c1 >= (double)a)) return false;
  p0 = c0 > (double)a ? (int)c0 : a;
  p1 = c1 < (double)(b - 1) ? (int)c1 : b - 1;
  return true;
}

// The live records of a call: the first min(n, *n_live), or all n when
// n_live is null.
__device__ __forceinline__ int live_count(int n, const int* n_live) {
  return n_live == nullptr ? n : max(0, min(n, __ldg(n_live)));
}

// Each live record's span: the pixels of [0, kMaxCoord) in x and in global
// y whose centres pass its bbox clamp, as short4 (x0, x1, y0, y1),
// inclusive; (1, 0, 1, 0) where there is none. Records past the live count
// are never read.
__global__ void span_kernel(const float* __restrict__ rec, int n,
                            const int* __restrict__ n_live,
                            short4* __restrict__ spans) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= live_count(n, n_live)) return;
  const float2 lo = __ldg(reinterpret_cast<const float2*>(
      rec + (size_t)k * kRec + 10));
  const float2 hi = __ldg(reinterpret_cast<const float2*>(
      rec + (size_t)k * kRec + 12));
  int x0, x1, y0, y1;
  const bool pass = centre_range(lo.x, hi.x, 0, kMaxCoord, x0, x1) &&
                    centre_range(lo.y, hi.y, 0, kMaxCoord, y0, y1);
  spans[k] = pass ? make_short4(x0, x1, y0, y1) : make_short4(1, 0, 1, 0);
}

// A span clipped to the rect [xa, xb) x [ya, yb) (global rows), and
// whether anything is left.
__device__ __forceinline__ bool clip(short4 s, int xa, int xb, int ya, int yb,
                                     int4& sp) {
  sp = make_int4(max((int)s.x, xa), min((int)s.y, xb - 1), max((int)s.z, ya),
                 min((int)s.w, yb - 1));
  return sp.x <= sp.y && sp.z <= sp.w;
}

// One cull pass of a block: thread tid offers idx[j], the pass's entry
// j * kThreads + tid, where pass[j] holds; the offered entries are
// appended to out[count...] in entry order (with their clipped spans when
// sspan is given). Returns the new count, the same in every thread.
// swarp alternates between two buffers by parity: one barrier a pass
// keeps a pass's counts apart from the next one's.
__device__ __forceinline__ int compact(const bool (&pass)[kPerThread],
                                       const int (&idx)[kPerThread],
                                       const int4 (&sp)[kPerThread],
                                       int count, int* out, short4* sspan,
                                       int (*swarp)[32], int parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned m[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    m[j] = __ballot_sync(0xffffffffu, pass[j]);
    if (lane == 0) swarp[parity][j * kWarps + warp] = __popc(m[j]);
  }
  __syncthreads();
  // Positions in entry order: pass j's entries follow pass j - 1's, and
  // within a pass warp w's follow warp w - 1's. Lane i scans the i-th
  // (j, w) count.
  const int c = swarp[parity][lane];
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  const int excl = incl - c;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int off = count + __shfl_sync(0xffffffffu, excl, j * kWarps + warp);
    if (pass[j]) {
      const int pos = off + __popc(m[j] & ((1u << lane) - 1u));
      out[pos] = idx[j];
      if (sspan != nullptr)
        sspan[pos] = make_short4(sp[j].x, sp[j].y, sp[j].z, sp[j].w);
    }
  }
  return count + __shfl_sync(0xffffffffu, incl, 31);
}

// Block (c, s): the live records of [c * kChunk, (c + 1) * kChunk) whose
// span meets super-tile s, ascending, to list[s * n + c * kChunk ...],
// their count to cnt[s * gridDim.x + c] (0 for a chunk past the live
// count).
__global__ void __launch_bounds__(kThreads) super_kernel(
    const short4* __restrict__ spans, int n, const int* __restrict__ n_live,
    int width, int height, int y_start, int* __restrict__ list,
    int* __restrict__ cnt) {
  __shared__ int swarp[2][32];
  const int tid = threadIdx.x;
  const int sgw = (width + kSuperW - 1) / kSuperW;
  const int sx0 = (blockIdx.y % sgw) * kSuperW;
  const int sy0 = (blockIdx.y / sgw) * kSuperH;
  const int xb = min(sx0 + kSuperW, width);
  const int ya = sy0 + y_start, yb = min(sy0 + kSuperH, height) + y_start;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, live_count(n, n_live));
  int* out = list + (size_t)blockIdx.y * n + c0;
  int count = 0, parity = 0;
  for (int base = c0; base < c1; base += kPass) {
    bool pass[kPerThread];
    int idx[kPerThread];
    int4 sp[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      idx[j] = base + j * kThreads + tid;
      pass[j] = idx[j] < c1 &&
                clip(__ldg(spans + idx[j]), sx0, xb, ya, yb, sp[j]);
    }
    count = compact(pass, idx, sp, count, out, nullptr, swarp, parity);
    parity ^= 1;
  }
  if (tid == 0) cnt[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = count;
}

template <bool kClear>
__global__ void __launch_bounds__(kThreads, kMinBlocks) visibility_kernel(
    const float* __restrict__ rec, const short4* __restrict__ spans, int n,
    const int* __restrict__ list, const int* __restrict__ cnt, int chunks,
    const int* __restrict__ n_live,
    const float* __restrict__ z_in, const int* __restrict__ id_in, int width,
    int height, int y_start, float* __restrict__ z_out,
    int* __restrict__ id_out) {
  __shared__ __align__(16) float srec[kStage * kRec];
  __shared__ short4 sspan[kCap];  // x0, x1, global y0, y1 (inclusive)
  __shared__ int slist[kCap];
  __shared__ int swarp[2][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  // This warp's 32 columns and kRows rows (frame rows; global adds y_start).
  const int wx0 = tx0 + (warp % kWarpsX) * 32;
  const int wy0 = ty0 + (warp / kWarpsX) * kRows;
  const int gy0 = wy0 + y_start;
  const int px = wx0 + lane;
  const float xs = (float)px + 0.5f;
  // The tile clipped to the frame, in global rows.
  const int xb = min(tx0 + kTileW, width);
  const int ya = ty0 + y_start, yb = min(ty0 + kTileH, height) + y_start;
  // This tile's super-tile: its list and its chunks' counts.
  const int sgw = (width + kSuperW - 1) / kSuperW;
  const int s = (ty0 / kSuperH) * sgw + tx0 / kSuperW;
  const int* slst = list + (size_t)s * n;
  const int* scnt = cnt + (size_t)s * chunks;
  // The chunks that hold a live record.
  const int walk = (live_count(n, n_live) + kChunk - 1) / kChunk;

  float z[kRows];
  int id[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int py = wy0 + r;
    const bool in_frame = px < width && py < height;
    const size_t p = (size_t)py * width + px;
    z[r] = (!kClear && in_frame) ? z_in[p] : INFINITY;
    id[r] = (!kClear && in_frame) ? id_in[p] : -1;
  }

  int chunk = 0, base = 0, parity = 0;
  for (;;) {
    // Cull passes over the super-tile's chunks, in order, until the list
    // may not take another pass or the chunks end.
    int count = 0;  // survivors listed, the same in every thread
    while (chunk < walk && count <= kCap - kPass) {
      const int m = __ldg(scnt + chunk);
      if (base >= m) {
        ++chunk;
        base = 0;
        continue;
      }
      const int* entries = slst + (size_t)chunk * kChunk + base;
      bool pass[kPerThread];
      int idx[kPerThread];
      int4 sp[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = j * kThreads + tid;
        idx[j] = e < m - base ? __ldg(entries + e) : 0;
        pass[j] = e < m - base &&
                  clip(__ldg(spans + idx[j]), tx0, xb, ya, yb, sp[j]);
      }
      count = compact(pass, idx, sp, count, slist, sspan, swarp, parity);
      parity ^= 1;
      base += kPass;
    }
    __syncthreads();  // the list is complete

    // Drain: stage kStage survivors' records at a time, then walk them in
    // order.
    for (int c0 = 0; c0 < count; c0 += kStage) {
      const int cn = min(kStage, count - c0);
      const float4* g = reinterpret_cast<const float4*>(rec);
      float4* st = reinterpret_cast<float4*>(srec);
      for (int j = tid; j < cn * (kRec / 4); j += kThreads)
        st[j] = __ldg(g + (size_t)slist[c0 + j / (kRec / 4)] * (kRec / 4) +
                      j % (kRec / 4));
      __syncthreads();
      for (int k = 0; k < cn; ++k) {
        const short4 sp = sspan[c0 + k];
        if (sp.y < wx0 || sp.x > wx0 + 31 || sp.w < gy0 ||
            sp.z > gy0 + kRows - 1)
          continue;  // the record misses this warp's pixels
        const float* r = srec + k * kRec;
        const int rlo = sp.z - gy0, rhi = sp.w - gy0;
        const int tri = (int)r[14];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (rr < rlo || rr > rhi) continue;
          const float ys = (float)(gy0 + rr) + 0.5f;
          float e0 = r[0] * xs + r[2] * ys + r[4];
          float e1 = r[1] * xs + r[3] * ys + r[5];
          float e2 = r[6] - e0 - e1;
          bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
          inside = inside && (xs >= r[10] && xs <= r[12] + 1.0f &&
                              ys >= r[11] && ys <= r[13] + 1.0f);
          float depth = r[7] * xs + r[8] * ys + r[9];
          float cand = inside ? depth : INFINITY;
          bool better = cand < z[rr];
          if (!kClear)
            better = better || (cand == z[rr] && inside && tri < id[rr]);
          if (better) {
            z[rr] = cand;
            id[rr] = tri;
          }
        }
      }
      __syncthreads();  // the staged records and the list are reused
    }
    if (chunk >= walk) break;
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int py = wy0 + r;
    if (px < width && py < height) {
      const size_t p = (size_t)py * width + px;
      z_out[p] = z[r];
      id_out[p] = id[r];
    }
  }
}

// Super-tiles and record chunks of a call.
int supers(int width, int height) {
  return ((width + kSuperW - 1) / kSuperW) *
         ((height + kSuperH - 1) / kSuperH);
}
int chunks_of(int n) { return (n + kChunk - 1) / kChunk; }

template <bool kClear>
int launch(const float* rec, int n, const int* n_live, void* spans,
           int* list, int* cnt, const float* z_in, const int* id_in,
           int width, int height, int y_start, float* z_out, int* id_out,
           void* stream) {
  if (n < 0 || width < 0 || height < 0 || y_start < 0 ||
      width > kMaxCoord || height > kMaxCoord - y_start)
    return (int)cudaErrorInvalidValue;
  if (width == 0 || height == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  short4* sp = static_cast<short4*>(spans);
  const int chunks = chunks_of(n);
  if (n > 0) {
    span_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        rec, n, n_live, sp);
    super_kernel<<<dim3(chunks, supers(width, height)), kThreads, 0, st>>>(
        sp, n, n_live, width, height, y_start, list, cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  visibility_kernel<kClear><<<grid, kThreads, 0, st>>>(
      rec, sp, n, list, cnt, chunks, n_live, z_in, id_in, width, height,
      y_start, z_out, id_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch a call needs, in elements: sizes[0] = n short4 spans,
// sizes[1] = super-tiles x n list entries, sizes[2] = super-tiles x chunks
// counts (all int32 but the spans).
extern "C" int sr_visibility_scratch(int n, int width, int height,
                                     long long* sizes) {
  sizes[0] = n;
  sizes[1] = (long long)supers(width, height) * n;
  sizes[2] = (long long)supers(width, height) * chunks_of(n);
  return (int)cudaSuccess;
}

// n_live: a device pointer to the live record count, or null for all n.
extern "C" int sr_visibility_merge(const float* rec, int n, void* spans,
                                   int* list, int* cnt, const int* n_live,
                                   const float* z_in, const int* id_in,
                                   int width, int height, int y_start,
                                   float* z_out, int* id_out, void* stream) {
  return launch<false>(rec, n, n_live, spans, list, cnt, z_in, id_in, width,
                       height, y_start, z_out, id_out, stream);
}

extern "C" int sr_visibility(const float* rec, int n, void* spans, int* list,
                             int* cnt, int width, int height, int y_start,
                             float* z_out, int* id_out, void* stream) {
  return launch<true>(rec, n, nullptr, spans, list, cnt, nullptr, nullptr,
                      width, height, y_start, z_out, id_out, stream);
}
