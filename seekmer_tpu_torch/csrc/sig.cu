// K3: per-read EC signature (sorted distinct EC ids, capped at C).
//
// Replaces seekmer_tpu/ops/sig_pallas.py `_sig_kernel` with
// `_bitonic_sort_rows` (called through `read_signatures_pallas`). The TPU
// form built its compare-exchange network from pairs of circular lane
// rolls over a (block, W >= 128) plane and sorted twice, the second time
// to move the distinct ids to the front. Here one warp owns one read: the
// row is loaded into shared memory (missed and invalid windows become
// SIG_PAD, the tail up to the power-of-two width W is SIG_PAD), sorted by
// a bitonic network with __syncwarp between stages, the first of each run
// is flagged and counted, and a warp prefix sum over the flags compacts
// the distinct ids in order, so no second sort is needed. The first C ids
// are written, padded with SIG_PAD, with mapped = 1 <= n_distinct <= C.
//
// What bounds it on Hopper: shared-memory traffic of the sort,
// log2(W) (log2(W) + 1) / 2 stages of W/2 compare-exchanges per read
// (36 stages at W = 256), not device memory (one 5-byte read per window,
// 68 bytes written per read). Four reads per 128-thread block keep the
// shared footprint at 4 W int32 (16 KB at the largest W = 1024).

#include "common.cuh"

namespace {

constexpr int READS_PER_BLOCK = 4;

__global__ void sig_kernel(const int32_t* __restrict__ ecs,
                           const uint8_t* __restrict__ valid,
                           int32_t* __restrict__ sig,
                           uint8_t* __restrict__ mapped, int64_t B, int P,
                           int W, int C) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * READS_PER_BLOCK + warp;
  if (b >= B) return;  // uniform across the warp; only __syncwarp is used
  int32_t* s = smem + warp * W;
  const int32_t* erow = ecs + b * P;
  const uint8_t* vrow = valid + b * P;
  for (int i = lane; i < W; i += 32) {
    int32_t v = seekmer::SIG_PAD;
    if (i < P) {
      int32_t e = erow[i];
      if (vrow[i] && e >= 0) v = e;
    }
    s[i] = v;
  }
  __syncwarp();
  for (int size = 2; size <= W; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < W / 2; t += 32) {
        int i = 2 * t - (t & (stride - 1));  // lower index of pair t
        int j = i + stride;
        bool ascending = (i & size) == 0;
        int32_t a = s[i], c = s[j];
        if ((a > c) == ascending) {
          s[i] = c;
          s[j] = a;
        }
      }
      __syncwarp();
    }
  }
  // each lane owns a contiguous chunk of the sorted row
  const int chunk = W / 32;
  const int lo = lane * chunk;
  int n = 0;
  for (int i = lo; i < lo + chunk; ++i) {
    int32_t v = s[i];
    n += (v != seekmer::SIG_PAD) && (i == 0 || v != s[i - 1]);
  }
  int incl = n;  // inclusive warp scan of the per-lane distinct counts
  for (int d = 1; d < 32; d <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int pos = incl - n;
  int32_t* srow = sig + b * C;
  for (int i = lo; i < lo + chunk && pos < C; ++i) {
    int32_t v = s[i];
    if ((v != seekmer::SIG_PAD) && (i == 0 || v != s[i - 1])) {
      srow[pos++] = v;
    }
  }
  for (int q = lane; q < C; q += 32) {
    if (q >= total) srow[q] = seekmer::SIG_PAD;
  }
  if (lane == 0) mapped[b] = (total >= 1) && (total <= C);
}

}  // namespace

extern "C" int seekmer_read_signatures(const void* ecs, const void* valid,
                                       void* sig, void* mapped, void* stream,
                                       int64_t device, int64_t B, int64_t P,
                                       int64_t W, int64_t C) {
  cudaSetDevice((int)device);
  if (B > 0) {
    size_t shmem = (size_t)READS_PER_BLOCK * W * sizeof(int32_t);
    sig_kernel<<<seekmer::grid_for(B, READS_PER_BLOCK), READS_PER_BLOCK * 32,
                 shmem, (cudaStream_t)stream>>>(
        (const int32_t*)ecs, (const uint8_t*)valid, (int32_t*)sig,
        (uint8_t*)mapped, B, (int)P, (int)W, (int)C);
  }
  return (int)cudaGetLastError();
}
