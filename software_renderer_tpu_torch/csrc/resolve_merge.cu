// Overflow G-buffer resolve: where a pixel's winning triangle has one of
// the first n_live rows of the overflow list, write that row's attribute
// planes px * x + py * y + pc at the pixel center into gb_out, and write
// nothing elsewhere: gb_out is a fresh buffer (the fused kernel reads its
// seed planes only where the seed's id won) or a seed the caller lets it
// change (binned_pipeline's resolve output; the wrapper clones a seed the
// caller keeps). Replaces the TPU kernel _resolve_merge_kernel
// (software_renderer_tpu/ops/binning.py:683); the plain version is
// resolve_merge_plain in software_renderer_tpu_torch/ops/binning.py.
//
// The rows are a static list; a device count n_live (JAX's n_live) says
// how many are live, so no count reaches the host.
//
// The TPU kernel walks every record for every tile. Here a pixel finds its
// row with one read of a slot map, slots[t] = triangle t's row in the list
// (the scatter index of overflow_ids, at or past n_live where t did not
// spill).
//
// Bound: memory, the id of every pixel and, per live winner, its slot and
// its A plane writes. Winners are sparse (about one pixel in nine on a
// spill frame), so a thread per pixel would run the plane code in warps
// that are mostly idle. Here a fixed grid of a few blocks per SM strides
// over the frame, each lane scanning 4 pixels a step (one int4 id load,
// prefetched a step ahead); each warp queues its winners in a ring in
// shared memory and evaluates them 32 at a time, with the channel count a
// template argument so that a winner's 3A plane loads are in flight
// together. Each block reads the count once, so at a count of 0 every
// block returns at once and the launch costs little more than an empty
// one.
#include <stdint.h>

#include "common.cuh"

namespace {

// Threads a block; blocks an SM in the grid; resident blocks an SM asked
// of ptxas; pixels a lane scans a step (a multiple of 4 moves ids as
// int4). tools/sweep_resolve_merge.py times the alternatives.
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kMinBlocks = 4;
constexpr int kGroup = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 32 * kGroup;  // pixels a warp scans a step
// Each warp's queue of winners: a ring that holds a step's winners on top
// of fewer than 32 left from the steps before.
constexpr int kRing = 256;
static_assert(kSpan + 31 <= kRing, "a step's winners overflow the ring");
constexpr int kRecBase = 11;  // stream-row columns before the planes
constexpr unsigned kFull = 0xffffffffu;

// A group's winner ids, -1 past the frame. Each branch compares p0 with
// npix itself, and nothing at or past npix is read: the prefetch of a
// lane's last step starts there (tests/test_torch_cuda.py puts spilled
// ids past the frame to catch a read of them).
__device__ __forceinline__ void load_ids(const int* __restrict__ tid,
                                         int p0, int npix, bool vec,
                                         int (&t)[kGroup]) {
  if (p0 >= npix) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) t[k] = -1;
  } else if (vec && npix - p0 >= kGroup) {
#pragma unroll
    for (int u = 0; u + 3 < kGroup; u += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(tid + p0 + u));
      t[u] = v.x; t[u + 1] = v.y; t[u + 2] = v.z; t[u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      t[k] = p0 + k < npix ? __ldg(tid + p0 + k) : -1;
  }
}

// One queued winner's planes, evaluated at its pixel center as
// pixel_centers rounds it.
template <int kA>
__device__ __forceinline__ void write_winner(
    const float* __restrict__ rows, int wtot, int n_ch, int p, int row,
    int width, int npix, int y_start, float* __restrict__ gb_out) {
  const float* pl = rows + (size_t)row * wtot + kRecBase;
  const float xs = (float)(p % width) + 0.5f;
  const float ys = (float)(p / width + y_start) + 0.5f;
#pragma unroll
  for (int a = 0; a < (kA > 0 ? kA : n_ch); ++a)
    gb_out[(size_t)a * npix + p] = __ldg(pl + 3 * a) * xs +
                                   __ldg(pl + 3 * a + 1) * ys +
                                   __ldg(pl + 3 * a + 2);
}

// kA: the channels, known at compile time so that a pixel's 3A plane
// loads are all in flight at once (0: n_channels, read at run time).
template <int kA>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resolve_merge_kernel(const float* __restrict__ rows, int n,
                         const int* __restrict__ n_live, int wtot,
                         int n_channels, const int* __restrict__ tid,
                         const int* __restrict__ slots, int n_slots,
                         int width, int height, int y_start,
                         float* __restrict__ gb_out) {
  // Each warp queues the live winners it finds, (pixel, row), in pixel
  // order, and evaluates them 32 at a time: whole warps evaluate planes,
  // and no warp waits for another.
  __shared__ int s_pix[kWarps][kRing];
  __shared__ int s_row[kWarps][kRing];
  __shared__ int s_live;
  if (threadIdx.x == 0)
    s_live = n_live != nullptr ? max(0, min(n, __ldg(n_live))) : n;
  __syncthreads();
  const int live = s_live;
  if (live == 0) return;
  const int n_ch = kA > 0 ? kA : n_channels;
  const int npix = width * height;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* q_pix = s_pix[warp];
  int* q_row = s_row[warp];
  const int stride = gridDim.x * kWarps * kSpan;
  const bool vec_tid = kGroup % 4 == 0 && ((uintptr_t)tid & 15) == 0;
  const int first = (blockIdx.x * kWarps + warp) * kSpan;
  int t[kGroup];
  load_ids(tid, first + lane * kGroup, npix, vec_tid, t);
  int head = 0, tail = 0;  // the warp's queue, the same in every lane
  // The bound is the warp's own, so its lanes take every step together
  // (the shuffles below need them all).
  for (int base = first; base < npix; base += stride) {
    const int p0 = base + lane * kGroup;
    // The next step's ids are in flight while this step runs.
    int tn[kGroup];
    load_ids(tid, p0 + stride, npix, vec_tid, tn);
    int r[kGroup];
    unsigned hit = 0;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      r[k] = 0;
      if (t[k] < 0 || t[k] >= n_slots) continue;
      const int s = __ldg(slots + t[k]);
      if (s >= 0 && s < live) {
        r[k] = s;
        hit |= 1u << k;
        ++cnt;
      }
    }
    // Queue the winners behind those left over: a prefix sum over the
    // lanes places each lane's.
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int pos = tail + incl - cnt;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (hit >> k & 1u) {
        q_pix[pos & (kRing - 1)] = p0 + k;
        q_row[pos & (kRing - 1)] = r[k];
        ++pos;
      }
    }
    tail += __shfl_sync(kFull, incl, 31);
    __syncwarp();
    for (; tail - head >= 32; head += 32) {
      const int i = (head + lane) & (kRing - 1);
      write_winner<kA>(rows, wtot, n_ch, q_pix[i], q_row[i], width, npix,
                       y_start, gb_out);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kGroup; ++k) t[k] = tn[k];
  }
  if (lane < tail - head) {
    const int i = (head + lane) & (kRing - 1);
    write_winner<kA>(rows, wtot, n_ch, q_pix[i], q_row[i], width, npix,
                     y_start, gb_out);
  }
}

}  // namespace

// n_live: a device pointer to the live row count, or null for all n;
// slots: [n_slots] int32, triangle id -> row; gb_out: [A, H, W], of which
// only the live winners' pixels are written; sms: the card's SM count,
// which sizes the grid.
extern "C" int sr_resolve_merge(const float* rows, int n, const int* n_live,
                                int wtot, int n_channels, const int* tid,
                                const int* slots, int n_slots, int width,
                                int height, int y_start, float* gb_out,
                                int sms, void* stream) {
  const size_t need =
      ((size_t)width * height + kWarps * kSpan - 1) / (kWarps * kSpan);
  const size_t cap = (size_t)(sms > 0 ? sms : 1) * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  if (blocks == 0 || n_channels <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define SR_RESOLVE_MERGE(A)                                                 \
  resolve_merge_kernel<A><<<blocks, kThreads, 0, st>>>(                     \
      rows, n, n_live, wtot, n_channels, tid, slots, n_slots, width, height, \
      y_start, gb_out)
  switch (n_channels) {
    case 1: SR_RESOLVE_MERGE(1); break;
    case 2: SR_RESOLVE_MERGE(2); break;
    case 3: SR_RESOLVE_MERGE(3); break;
    case 4: SR_RESOLVE_MERGE(4); break;
    case 5: SR_RESOLVE_MERGE(5); break;
    case 6: SR_RESOLVE_MERGE(6); break;
    case 7: SR_RESOLVE_MERGE(7); break;
    case 8: SR_RESOLVE_MERGE(8); break;
    case 9: SR_RESOLVE_MERGE(9); break;
    default: SR_RESOLVE_MERGE(0);
  }
#undef SR_RESOLVE_MERGE
  return (int)cudaGetLastError();
}
