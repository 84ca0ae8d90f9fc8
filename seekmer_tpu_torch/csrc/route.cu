// R1 and R2: the routing of the prefix-sharded index's lookup.
//
// Replace the XLA code of seekmer_tpu/parallel/prefix_shard.py
// `routed_lookup`: the hash and owner of every lane, the `lax.sort` of the
// lanes by owner, the associative-scan rank within an owner and the
// `.at[dest].set` scatters into the (D, K) send slab (:205-233), and the
// unscatter of the returned ECs (:247-249). A lane's owner is the top
// `bits` bits of the main-table slot hash, computed with the very function
// K2 uses for the home bucket (common.cuh `hash_kmer`), so the owner and
// the home bucket on the owner's shard come from one hash.
//
// R1 has two entries:
//
//   - seekmer_route_rank, once a lookup: a thread takes 8 lanes, strided
//     by the block so loads and stores are coalesced. The lanes of a warp
//     that share an owner find each other with __match_any_sync; their
//     leader takes their local ranks with one shared-memory atomicAdd on
//     the owner's counter (D <= 64 counters a block); after a barrier one
//     thread an owner adds the block's count to the global count with one
//     atomicAdd, which gives the block's base. rank = base + local rank.
//     The sort and the scan are gone: ranks within an owner are a
//     permutation of 0..count-1 whose order varies from run to run (the
//     order in which blocks and warps reach the counters). The ECs and the
//     number of rounds depend only on each owner's count, so they do not
//     vary; the plain version (ops/route.py) ranks by a stable sort.
//     Invalid lanes get owner D and rank -1 and route nowhere;
//   - seekmer_route_dispatch, once a round: a thread a lane; a lane of
//     owner d ranked in [base, base + K) writes its hi, lo and own index
//     to slot d * K + rank - base of the send slab. Slots past an owner's
//     count in this round are not written: the receiver knows the counts
//     and marks them invalid, so no valid bytes cross.
//
// R2, seekmer_route_unroute, once a round: a thread a slot; slot j of
// owner d is filled when j < counts[d] - base, and then writes its
// returned EC to the lane named by the slab's return index.
//
// What bounds them: the bytes they move, a few bytes a lane (R1's rank
// entry reads hi, lo and valid and writes owner and rank; dispatch reads
// owner and rank and writes 12 bytes a routed lane; R2 reads 8 bytes a
// filled slot and writes 4). Neither is tuned yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 8;
constexpr int kMaxOwners = 64;

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
            const uint8_t* __restrict__ valid, int32_t* __restrict__ owner_out,
            int32_t* __restrict__ rank_out, int32_t* __restrict__ counts,
            int64_t N, int D, int bits) {
  __shared__ int32_t local[kMaxOwners];
  __shared__ int32_t base[kMaxOwners];
  for (int d = threadIdx.x; d < D; d += kThreads) local[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int64_t first = (int64_t)blockIdx.x * kThreads * kLanesPerThread +
                        threadIdx.x;
  int32_t own[kLanesPerThread], rk[kLanesPerThread];
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int64_t key = first + (int64_t)i * kThreads;
    int o = D;
    if (key < N && valid[key]) {
      o = bits ? (int)(seekmer::hash_kmer((uint32_t)hi[key],
                                          (uint32_t)lo[key]) >>
                       (32 - bits))
               : 0;
    }
    // every lane of the warp takes part (a lane past N carries owner D)
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (lane == leader && o < D) start = atomicAdd(&local[o], __popc(peers));
    start = __shfl_sync(peers, start, leader);
    own[i] = o;
    rk[i] = start + __popc(peers & below);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads)
    base[d] = local[d] ? atomicAdd(counts + d, local[d]) : 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int64_t key = first + (int64_t)i * kThreads;
    if (key < N) {
      owner_out[key] = own[i];
      rank_out[key] = own[i] < D ? base[own[i]] + rk[i] : -1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                const int32_t* __restrict__ owner,
                const int32_t* __restrict__ rank,
                int32_t* __restrict__ send_hi, int32_t* __restrict__ send_lo,
                int32_t* __restrict__ ret, int64_t N, int D, int64_t base,
                int64_t K) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const int o = owner[i];
  if (o >= D) return;
  const int64_t r = (int64_t)rank[i] - base;
  if (r < 0 || r >= K) return;
  const int64_t s = (int64_t)o * K + r;
  send_hi[s] = hi[i];
  send_lo[s] = lo[i];
  ret[s] = (int32_t)i;
}

__global__ void __launch_bounds__(kThreads)
unroute_kernel(const int32_t* __restrict__ ec_back,
               const int32_t* __restrict__ ret,
               const int32_t* __restrict__ counts, int32_t* __restrict__ ecs,
               int D, int64_t base, int64_t K) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= (int64_t)D * K) return;
  const int64_t d = s / K;
  if (s - d * K < (int64_t)__ldg(counts + d) - base) ecs[ret[s]] = ec_back[s];
}

}  // namespace

extern "C" int seekmer_route_rank(const void* hi, const void* lo,
                                  const void* valid, void* owner, void* rank,
                                  void* counts, void* stream, int64_t device,
                                  int64_t N, int64_t D, int64_t bits) {
  cudaSetDevice((int)device);
  if (D < 1 || D > kMaxOwners) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, D * sizeof(int32_t), s);
  if (N > 0) {
    rank_kernel<<<seekmer::grid_for(N, kThreads * kLanesPerThread), kThreads,
                  0, s>>>((const int32_t*)hi, (const int32_t*)lo,
                          (const uint8_t*)valid, (int32_t*)owner,
                          (int32_t*)rank, (int32_t*)counts, N, (int)D,
                          (int)bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int seekmer_route_dispatch(const void* hi, const void* lo,
                                      const void* owner, const void* rank,
                                      void* send_hi, void* send_lo, void* ret,
                                      void* stream, int64_t device, int64_t N,
                                      int64_t D, int64_t base, int64_t K) {
  cudaSetDevice((int)device);
  if (N > 0) {
    dispatch_kernel<<<seekmer::grid_for(N, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const int32_t*)owner,
        (const int32_t*)rank, (int32_t*)send_hi, (int32_t*)send_lo,
        (int32_t*)ret, N, (int)D, base, K);
  }
  return (int)cudaGetLastError();
}

extern "C" int seekmer_route_unroute(const void* ec_back, const void* ret,
                                     const void* counts, void* ecs,
                                     void* stream, int64_t device, int64_t D,
                                     int64_t base, int64_t K) {
  cudaSetDevice((int)device);
  if (D * K > 0) {
    unroute_kernel<<<seekmer::grid_for(D * K, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const int32_t*)ec_back, (const int32_t*)ret, (const int32_t*)counts,
        (int32_t*)ecs, (int)D, base, K);
  }
  return (int)cudaGetLastError();
}
