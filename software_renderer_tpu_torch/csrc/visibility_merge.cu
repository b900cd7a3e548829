// Record-walking visibility: rasterize raster records (coverage clamped to
// each record's bbox) into a (z, id) buffer. Replaces the TPU kernel
// _visibility_kernel (software_renderer_tpu/ops/rasterize_pallas.py:110) in
// both of its modes, as two instances of one template:
//
//   merge (kClear = false), entry sr_visibility_merge: start from the given
//     buffer and keep the lexicographic (depth, id) minimum, the overflow
//     pass of the binned paths; plain version visibility_merge_plain;
//   clear (kClear = true), entry sr_visibility: start from (inf, -1) in
//     registers and replace only on a strictly smaller depth, walking the
//     records in the order given (ascending id: the first drawn wins ties),
//     the `pallas` backend; plain version visibility_plain. Both plain
//     versions live in software_renderer_tpu_torch/ops/rasterize_kernel.py.
//
// One thread per pixel, 16x16 pixels per block. Records are staged in
// shared memory in chunks; a record whose bbox misses the block is skipped
// by the whole block (the per-pixel bbox clamp implies that test, so the
// skip changes no pixel). The lex minimum does not depend on the order of
// the records, so the TPU's waves are not needed.
//
// Bound: arithmetic, about 24 float operations per (pixel, record) pair
// whose bbox meets the block; records are broadcast from shared memory.
#include "common.cuh"

namespace {

constexpr int kRec = 16;     // REC_WIDTH
constexpr int kBlock = 16;   // block edge in pixels
constexpr int kChunk = 128;  // records staged per pass

template <bool kClear>
__global__ void visibility_kernel(
    const float* __restrict__ rec, int n, const float* __restrict__ z_in,
    const int* __restrict__ id_in, int width, int height, int y_start,
    float* __restrict__ z_out, int* __restrict__ id_out) {
  __shared__ float srec[kChunk * kRec];
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kBlock + threadIdx.y;
  const int tid = threadIdx.y * kBlock + threadIdx.x;
  const bool in_frame = px < width && py < height;
  const size_t p = (size_t)py * width + px;
  float z = (!kClear && in_frame) ? z_in[p] : INFINITY;
  int id = (!kClear && in_frame) ? id_in[p] : -1;
  const float xs = (float)px + 0.5f;
  const float ys = (float)(py + y_start) + 0.5f;
  // The block's pixel rect in global frame coordinates.
  const float bx_lo = (float)(blockIdx.x * kBlock);
  const float by_lo = (float)(blockIdx.y * kBlock + y_start);

  for (int base = 0; base < n; base += kChunk) {
    const int cnt = min(kChunk, n - base);
    __syncthreads();
    for (int j = tid; j < cnt * kRec; j += kBlock * kBlock)
      srec[j] = rec[(size_t)base * kRec + j];
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float* r = srec + k * kRec;
      if (!(r[12] >= bx_lo && r[10] < bx_lo + kBlock && r[13] >= by_lo &&
            r[11] < by_lo + kBlock))
        continue;
      float e0 = r[0] * xs + r[2] * ys + r[4];
      float e1 = r[1] * xs + r[3] * ys + r[5];
      float e2 = r[6] - e0 - e1;
      bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
      inside = inside && (xs >= r[10] && xs <= r[12] + 1.0f &&
                          ys >= r[11] && ys <= r[13] + 1.0f);
      float depth = r[7] * xs + r[8] * ys + r[9];
      float cand = inside ? depth : INFINITY;
      int tri = (int)r[14];
      bool better = cand < z;
      if (!kClear) better = better || (cand == z && inside && tri < id);
      if (better) {
        z = cand;
        id = tri;
      }
    }
  }
  if (in_frame) {
    z_out[p] = z;
    id_out[p] = id;
  }
}

template <bool kClear>
int launch(const float* rec, int n, const float* z_in, const int* id_in,
           int width, int height, int y_start, float* z_out, int* id_out,
           void* stream) {
  dim3 block(kBlock, kBlock);
  dim3 grid((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock);
  visibility_kernel<kClear><<<grid, block, 0, (cudaStream_t)stream>>>(
      rec, n, z_in, id_in, width, height, y_start, z_out, id_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sr_visibility_merge(const float* rec, int n, const float* z_in,
                                   const int* id_in, int width, int height,
                                   int y_start, float* z_out, int* id_out,
                                   void* stream) {
  return launch<false>(rec, n, z_in, id_in, width, height, y_start, z_out,
                       id_out, stream);
}

extern "C" int sr_visibility(const float* rec, int n, int width, int height,
                             int y_start, float* z_out, int* id_out,
                             void* stream) {
  return launch<true>(rec, n, nullptr, nullptr, width, height, y_start,
                      z_out, id_out, stream);
}
