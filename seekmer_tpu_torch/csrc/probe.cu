// K2: the whole bucketized k-mer lookup, stash included, in one kernel.
//
// Replaces seekmer_tpu/ops/probe_pallas.py `_match_kernel` (called through
// `_bucket_match_pallas`, `make_bucket_lookup`, `lookup_ecs_aux_pallas`)
// and the machinery around it in ops/probe.py `_lookup_flat`. On the TPU
// the hash and the row gather ran in XLA outside the kernel, the gathered
// (N, 128) rows round-tripped device memory, the kernel worked in a
// transposed (128, NC) lane layout with masked-reduction column
// extraction (Mosaic could not slice one lane), and stash keys were
// block-compacted into capped rounds under a while_loop. None of that is
// needed here: one warp per key hashes it, reads its home row with lane j
// on slot j of the hi, lo and ecaux slabs (three coalesced 128-byte
// loads), reduces the match across the warp, and, when the key is valid,
// absent and its home bucket is full, probes the stash row the same way.
//
// What bounds it on Hopper: random 128-byte row reads from a table far
// larger than L2 (about 1 GB at GENCODE scale), i.e. device-memory
// transactions per key; the compare is free beside them. The design reads
// only the three slabs it needs (384 of the row's 512 bytes) and never
// materialises anything per key but the two int32 results.
//
// Results equal `_lookup_flat`: ec = ecaux >> aux_bits (arithmetic shift,
// so an empty slot's -1 stays MISS), aux = ecaux & mask, and -1 / 0 for
// invalid or absent keys.

#include <climits>

#include "common.cuh"

namespace {

// 3-state value of one bucket row, reduced over the warp (the encoding of
// ops/probe.py `_bucket_lookup`): the matched slot's ecaux (>= 0), else -1
// if the bucket has an empty slot, else -2 (full, consult the stash).
__device__ __forceinline__ int32_t match_row(const int32_t* __restrict__ row,
                                             int G, int lane, int32_t khi,
                                             int32_t klo) {
  int32_t v = INT_MIN;  // lanes beyond the bucket never win the max
  if (lane < G) {
    int32_t h = row[lane];
    int32_t l = row[G + lane];
    if (h == khi && l == klo) {
      v = row[2 * G + lane];
    } else {
      v = (h == -1) ? -1 : -2;
    }
  }
  return __reduce_max_sync(0xffffffffu, v);
}

__global__ void lookup_kernel(const int32_t* __restrict__ hi,
                              const int32_t* __restrict__ lo,
                              const uint8_t* __restrict__ valid,
                              const int32_t* __restrict__ table,
                              const int32_t* __restrict__ stash,
                              int32_t* __restrict__ ec_out,
                              int32_t* __restrict__ aux_out, int64_t N,
                              int64_t main_buckets, int64_t stash_buckets,
                              int G, int aux_bits) {
  int64_t key = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (key >= N) return;  // uniform across the warp
  int32_t ec = -1, aux = 0;
  if (valid[key]) {
    int32_t khi = hi[key], klo = lo[key];
    uint32_t hb = seekmer::hash_kmer((uint32_t)khi, (uint32_t)klo) &
                  (uint32_t)(main_buckets - 1);
    int32_t m = match_row(table + (int64_t)hb * 4 * G, G, lane, khi, klo);
    if (m == -2) {
      uint32_t sb = seekmer::hash_kmer_stash((uint32_t)khi, (uint32_t)klo) &
                    (uint32_t)(stash_buckets - 1);
      m = match_row(stash + (int64_t)sb * 4 * G, G, lane, khi, klo);
    }
    if (m >= 0) {
      ec = m >> aux_bits;
      aux = m & ((1 << aux_bits) - 1);
    }
  }
  if (lane == 0) {
    ec_out[key] = ec;
    aux_out[key] = aux;
  }
}

}  // namespace

extern "C" int seekmer_lookup(const void* hi, const void* lo,
                              const void* valid, const void* table,
                              const void* stash, void* ec, void* aux,
                              void* stream, int64_t device, int64_t N,
                              int64_t main_buckets, int64_t stash_buckets,
                              int64_t bucket, int64_t aux_bits) {
  cudaSetDevice((int)device);
  if (N > 0) {
    const int threads = 256;  // 8 keys per block
    lookup_kernel<<<seekmer::grid_for(N * 32, threads), threads, 0,
                    (cudaStream_t)stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid,
        (const int32_t*)table, (const int32_t*)stash, (int32_t*)ec,
        (int32_t*)aux, N, main_buckets, stash_buckets, (int)bucket,
        (int)aux_bits);
  }
  return (int)cudaGetLastError();
}
