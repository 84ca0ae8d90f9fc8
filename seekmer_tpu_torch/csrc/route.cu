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
//   - seekmer_route_first, once a lookup: the owner and rank of every lane
//     and round 0's slab in one pass. A thread takes 8 lanes, strided by
//     the block so loads are coalesced, and starts all their loads (valid,
//     hi, lo) before it hashes any: a load of hi behind its valid byte
//     would cost a second round trip. The lanes of a warp that share an
//     owner find each other with __match_any_sync; their leader takes
//     their local ranks with one shared-memory atomicAdd on the owner's
//     counter (D <= 64 counters a block); after a barrier one thread an
//     owner adds the block's count to the global count with one
//     atomicAdd, which gives the block's base, and, if some of those ranks
//     reach K, takes their run of the spill list with one more. The
//     block's lanes are then staged in shared memory by owner and rank
//     (24 KB), so that the threads store each owner's run of consecutive
//     slots, slot owner * K + rank of the send slab for a lane ranked
//     below K and an entry (lane, owner, rank) of the compact spill list
//     for the others, in coalesced rows: stored straight from registers, a
//     warp's lanes scatter over D runs. No owner or rank array of N
//     entries is written, and a one-round lookup is one launch (plus the
//     counts' memset). The sort and the scan are gone: ranks within an
//     owner are a permutation of 0..count-1 whose order varies from run
//     to run (the order in which blocks and warps reach the counters), so
//     which lanes spill varies too. The ECs, the
//     counts and the number of rounds depend only on each owner's count,
//     so they do not vary; the plain version (ops/route.py) ranks by a
//     stable sort. Invalid lanes route nowhere;
//   - seekmer_route_spill, once a later round j: a thread a spill entry;
//     an entry ranked in [jK, (j+1)K) writes its lane's hi, lo and index
//     to slot owner * K + rank - jK. The host sizes it from the counts it
//     already gathers: sum_d max(counts[d] - K, 0) entries, no read back.
//
// Slots past an owner's count in a round are not written: the receiver
// knows the counts and marks them invalid, so no valid bytes cross.
//
// R2, seekmer_route_unroute, once a round: a thread a slot; slot j of
// owner d is filled when j < counts[d] - base, and then writes its
// returned EC to the lane named by the slab's return index.
//
// What bounds them: the bytes they move, a few bytes a lane (R1 reads hi,
// lo and valid, 9 bytes a lane, and writes 12 bytes a routed lane; R2
// reads 8 bytes a filled slot and writes 4). R2 is not tuned yet.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 8;
constexpr int kMaxOwners = 64;

__global__ void __launch_bounds__(kThreads)
first_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
             const uint8_t* __restrict__ valid, int32_t* __restrict__ send_hi,
             int32_t* __restrict__ send_lo, int32_t* __restrict__ ret,
             int32_t* __restrict__ counts, int32_t* __restrict__ spill,
             int64_t cap, int64_t N, int D, int bits, int64_t K) {
  constexpr int kLanes = kThreads * kLanesPerThread;
  __shared__ int32_t local[kMaxOwners];     // the block's lanes an owner
  __shared__ int32_t base[kMaxOwners];      // the block's first rank
  __shared__ int32_t off[kMaxOwners];       // its run in the staging
  __shared__ int32_t spill_at[kMaxOwners];  // its first spill entry
  __shared__ int32_t s_hi[kLanes], s_lo[kLanes], s_lane[kLanes];
  for (int d = threadIdx.x; d < D; d += kThreads) local[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int64_t first = (int64_t)blockIdx.x * kLanes + threadIdx.x;
  int32_t h[kLanesPerThread], l[kLanesPerThread];
  int32_t own[kLanesPerThread], rk[kLanesPerThread];
  bool v[kLanesPerThread];
  // every load in flight at once: hi and lo of invalid lanes too
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int64_t key = first + (int64_t)i * kThreads;
    const bool in = key < N;
    v[i] = in && valid[key];
    h[i] = in ? hi[key] : 0;
    l[i] = in ? lo[key] : 0;
  }
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    int o = D;
    if (v[i])
      o = bits ? (int)(seekmer::hash_kmer((uint32_t)h[i], (uint32_t)l[i]) >>
                       (32 - bits))
               : 0;
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
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int n = local[d];
    const int b = n ? atomicAdd(counts + d, n) : 0;
    int run = 0;
    for (int e = 0; e < d; ++e) run += local[e];
    base[d] = b;
    off[d] = run;
    // ranks b .. b + n - 1; those from K on spill, one run of the list
    const int64_t over = (int64_t)b + n - max((int64_t)b, K);
    spill_at[d] = over > 0 ? atomicAdd(counts + D, (int)over) : 0;
  }
  __syncthreads();
  // the block's lanes by owner, then by rank, in shared memory
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    if (own[i] < D) {
      const int p = off[own[i]] + rk[i];
      s_hi[p] = h[i];
      s_lo[p] = l[i];
      s_lane[p] = (int32_t)(first + (int64_t)i * kThreads);
    }
  }
  __syncthreads();
  // an owner's run is consecutive slots: coalesced stores
  const int total = off[D - 1] + local[D - 1];
  for (int p = threadIdx.x; p < total; p += kThreads) {
    int d = 0, z = D - 1;  // the last owner whose run starts at or before p
    while (d < z) {
      const int m = (d + z + 1) >> 1;
      if (off[m] <= p)
        d = m;
      else
        z = m - 1;
    }
    const int64_t r = (int64_t)base[d] + p - off[d];
    if (r < K) {
      const int64_t s = (int64_t)d * K + r;
      send_hi[s] = s_hi[p];
      send_lo[s] = s_lo[p];
      ret[s] = s_lane[p];
    } else {
      const int64_t at = spill_at[d] + (r - max((int64_t)base[d], K));
      if (at < cap) {
        spill[at] = s_lane[p];
        spill[cap + at] = d;
        spill[2 * cap + at] = (int32_t)r;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
spill_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
             const int32_t* __restrict__ spill, int64_t cap, int64_t S,
             int32_t* __restrict__ send_hi, int32_t* __restrict__ send_lo,
             int32_t* __restrict__ ret, int64_t base, int64_t K) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= S) return;
  const int64_t r = (int64_t)spill[2 * cap + i] - base;
  if (r < 0 || r >= K) return;
  const int32_t key = spill[i];
  const int64_t s = (int64_t)spill[cap + i] * K + r;
  send_hi[s] = hi[key];
  send_lo[s] = lo[key];
  ret[s] = key;
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

// R1, round 0: counts (D + 1 int32) gets each owner's count and, in
// counts[D], the spill list's length; the slab's slots of lanes ranked
// below K are written; spill (3 x cap int32: lanes, owners, ranks) gets
// the lanes ranked K or more, cap >= their number.
extern "C" int seekmer_route_first(const void* hi, const void* lo,
                                   const void* valid, void* send_hi,
                                   void* send_lo, void* ret, void* counts,
                                   void* spill, void* stream, int64_t device,
                                   int64_t N, int64_t D, int64_t bits,
                                   int64_t K, int64_t cap) {
  cudaSetDevice((int)device);
  if (D < 1 || D > kMaxOwners || K < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, (D + 1) * sizeof(int32_t), s);
  if (N > 0) {
    first_kernel<<<seekmer::grid_for(N, kThreads * kLanesPerThread),
                   kThreads, 0, s>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid,
        (int32_t*)send_hi, (int32_t*)send_lo, (int32_t*)ret,
        (int32_t*)counts, (int32_t*)spill, cap, N, (int)D, (int)bits, K);
  }
  return (int)cudaGetLastError();
}

// R1, a later round: the S spill entries ranked in [base, base + K) into
// the slab.
extern "C" int seekmer_route_spill(const void* hi, const void* lo,
                                   const void* spill, void* send_hi,
                                   void* send_lo, void* ret, void* stream,
                                   int64_t device, int64_t S, int64_t cap,
                                   int64_t base, int64_t K) {
  cudaSetDevice((int)device);
  if (S > 0) {
    spill_kernel<<<seekmer::grid_for(S, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, (const int32_t*)spill, cap, S,
        (int32_t*)send_hi, (int32_t*)send_lo, (int32_t*)ret, base, K);
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
