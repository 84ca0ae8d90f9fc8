// K7: strided mode's lookup, sampled probe + run-length gap fill, in one
// kernel.
//
// Replaces the XLA body of seekmer_tpu/ops/probe.py `lookup_ecs_strided`
// (:493-585): there a gather of the sampled columns, their lookup with the
// aux column, the left and right spreads and the coverage masks were each
// a pass of XLA over the batch, and the uncovered windows went through a
// block-compacted dense pass under a static cap (`block_compact`,
// `max_blocks`) with a `while_loop` over the residue. Here the warp that
// owns a segment probes its own uncovered windows: no cap, no compaction
// across the grid, no loop over the residue, no count read back.
//
// What bounds it on Hopper: like K2, random reads of bucket rows from a
// table far larger than L2, for the sampled windows (~1/s of them) and the
// uncovered ones (the ~k + s windows around a sequencing error, the EC-run
// boundaries); its own rows (hi, lo, valid in; ec out) are read and
// written once. A lookup round of `seekmer::warp_lookup` (lookup.cuh, K2's
// routine) costs its round trips however few of its 32 lanes hold a key,
// so the design keeps the rounds full:
//
//   - a warp owns a tile of `segs` consecutive segments (P windows each;
//     a pair's mates are two segments of one (B, 2P) row, so coverage
//     never crosses the mate boundary) and walks the batch grid-stride;
//     no block barrier, no global atomics;
//   - sampled columns 0, s, 2s, ... below P, then P - 1 (always, as the
//     JAX package samples them): each 32 sampled lanes of the tile ballot
//     their validity and append their keys to the warp's queue in shared
//     memory; every 32 queued keys are one lookup round, whose 3-state
//     result (the matched slot's ecaux, ec << aux_bits | d, else < 0) is
//     kept a sample in shared memory;
//   - then each 32 windows of a segment, one a lane, read their valid
//     byte and both samples around them: the left sample's EC when it hit
//     and its run length reaches the window, else the right one's; a
//     sampled window keeps its own result; the rest, when valid, append
//     their keys to the same queue, looked up 32 at a time in the same
//     launch. The tile's last partial round runs before the next tile;
//   - every window's ec is written once: a filled, sampled or invalid one
//     at its chunk pass (coalesced), a needy one when its round returns.
//
// Results equal ops/probe.py `lookup_ecs_strided`, itself equal to the
// JAX function: ec = ecaux >> aux_bits (arithmetic shift), d = ecaux &
// mask, a sample that missed or is invalid covers nothing.

#include <algorithm>

#include "lookup.cuh"

namespace {

constexpr int kWarps = 8;       // warps a block
constexpr int kMinBlocks = 4;   // <= 64 registers, as K2
constexpr int kMaxSlots = 520;  // sample slots a warp: segs * S <= 513
constexpr int kQueue = 64;      // < 32 carried + 32 appended

struct Params {
  int64_t n_seg;  // segments (rows x segments a row)
  int P, s, S, segs;
  uint32_t main_mask, stash_mask;
  int aux_bits;
};

struct Queue {
  int32_t* hi;
  int32_t* lo;
  int32_t* tag;
};

// Appends the keys of the lanes with `v` to the queue at their ranks;
// returns the new length.
__device__ __forceinline__ int enqueue(const Queue& q, int n, bool v,
                                       int32_t khi, int32_t klo, int32_t tag,
                                       int lane) {
  const uint32_t bal = __ballot_sync(seekmer::kFull, v);
  if (v) {
    const int r = n + __popc(bal & ((1u << lane) - 1));
    q.hi[r] = khi;
    q.lo[r] = klo;
    q.tag[r] = tag;
  }
  __syncwarp();
  return n + __popc(bal);
}

__device__ __forceinline__ int32_t ec_of(int32_t m, int aux_bits) {
  return m >= 0 ? m >> aux_bits : -1;
}

// One lookup round of the queue's first min(n, 32) keys; a sample's
// result goes to its slot, a needy window's EC to its place in `out`
// (`tag` is its offset from `out`). The keys past 32 move to the front.
// Returns the queue's new length.
template <int G, bool kSample>
__device__ __forceinline__ int flush(const Queue& q, int n, int32_t* slot,
                                     int32_t* __restrict__ out,
                                     const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ stash,
                                     const Params& p, int lane) {
  const bool v = lane < n;
  const int32_t tag = v ? q.tag[lane] : 0;
  const int32_t m = seekmer::warp_lookup<G>(v, v ? q.hi[lane] : 0,
                                            v ? q.lo[lane] : 0, table, stash,
                                            p.main_mask, p.stash_mask);
  if (v) {
    if (kSample) {
      slot[tag] = m;
    } else {
      out[tag] = ec_of(m, p.aux_bits);
    }
  }
  const int rest = n - 32;
  if (lane < rest) {  // reads [32, 32 + rest), writes [0, rest): disjoint
    q.hi[lane] = q.hi[32 + lane];
    q.lo[lane] = q.lo[32 + lane];
    q.tag[lane] = q.tag[32 + lane];
  }
  __syncwarp();
  return max(rest, 0);
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
strided_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ stash, int32_t* __restrict__ ec,
               Params p) {
  __shared__ int32_t slots_all[kWarps][kMaxSlots];
  __shared__ int32_t q_all[kWarps][3][kQueue];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* slot = slots_all[w];
  const Queue q{q_all[w][0], q_all[w][1], q_all[w][2]};
  const int P = p.P, s = p.s, S = p.S;
  const int32_t dmask = (1 << p.aux_bits) - 1;
  const int64_t warps = (int64_t)gridDim.x * kWarps;

  for (int64_t tile = (int64_t)blockIdx.x * kWarps + w; tile * p.segs < p.n_seg;
       tile += warps) {  // uniform across the warp
    const int64_t seg0 = tile * p.segs;
    const int T = (int)min((int64_t)p.segs, p.n_seg - seg0);
    const int64_t base = seg0 * P;  // the tile's first window
    int32_t* out = ec + base;
    int n = 0;

    // sampled windows, 32 lanes a step: valid keys to the queue
    const int lanes = T * S;
    for (int q0 = 0; q0 < lanes; q0 += 32) {
      const int i = q0 + lane;
      bool v = false;
      int32_t khi = 0, klo = 0;
      if (i < lanes) {
        const int t = i / S;
        const int col = min((i - t * S) * s, P - 1);  // the last: P - 1
        const int64_t x = base + (int64_t)t * P + col;
        v = valid[x];
        khi = hi[x];
        klo = lo[x];
        slot[i] = -1;  // an invalid sample covers nothing
      }
      n = enqueue(q, n, v, khi, klo, i, lane);
      if (n >= 32) n = flush<G, true>(q, n, slot, out, table, stash, p, lane);
    }
    if (n > 0) n = flush<G, true>(q, n, slot, out, table, stash, p, lane);

    // every window, 32 a step: fill from the samples, queue the needy
    for (int t = 0; t < T; ++t) {
      const int32_t* sl = slot + t * S;
      for (int c0 = 0; c0 < P; c0 += 32) {
        const int col = c0 + lane;
        const int32_t x = t * P + col;  // offset from `out`
        bool need = false;
        if (col < P) {
          const bool v = valid[base + x];
          const int gap = col / s, pl = gap * s;
          const int32_t ml = sl[gap];
          int32_t val;
          if (col == P - 1) {
            val = ec_of(sl[S - 1], p.aux_bits);
          } else if (col == pl) {
            val = ec_of(ml, p.aux_bits);
          } else {
            const int32_t mr = sl[gap + 1];
            const int pr = min(pl + s, P - 1);
            const bool cov_l = ml >= 0 && (ml & dmask) >= col - pl;
            const bool cov_r = mr >= 0 && (mr & dmask) >= pr - col;
            val = cov_l ? ml >> p.aux_bits : cov_r ? mr >> p.aux_bits : -1;
            need = v && !cov_l && !cov_r;
          }
          if (!need) out[x] = v ? val : -1;
        }
        int32_t khi = 0, klo = 0;
        if (need) {
          khi = hi[base + x];
          klo = lo[base + x];
        }
        n = enqueue(q, n, need, khi, klo, x, lane);
        if (n >= 32) {
          n = flush<G, false>(q, n, slot, out, table, stash, p, lane);
        }
      }
    }
    if (n > 0) n = flush<G, false>(q, n, slot, out, table, stash, p, lane);
    __syncwarp();  // the next tile overwrites the slots
  }
}

template <int G>
int launch(const void* hi, const void* lo, const void* valid,
           const void* table, const void* stash, void* ec,
           cudaStream_t stream, int device, const Params& p) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strided_kernel<G>,
                                                kWarps * 32, 0);
  const int64_t tiles = (p.n_seg + p.segs - 1) / p.segs;
  const int grid = (int)std::max<int64_t>(
      1, std::min<int64_t>(seekmer::grid_for(tiles, kWarps),
                           (int64_t)sms * std::max(per_sm, 1)));
  strided_kernel<G><<<grid, kWarps * 32, 0, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid,
      (const int32_t*)table, (const int32_t*)stash, (int32_t*)ec, p);
  return (int)cudaGetLastError();
}

}  // namespace

// n_seg segments of P windows, laid end to end (a (B, W) row of W = g P
// windows is g segments); S = ceil(P / s) + 1 sampled columns a segment,
// segs segments a warp's tile (ops/strided_cuda.py `strided_plan`).
extern "C" int seekmer_strided_lookup(const void* hi, const void* lo,
                                      const void* valid, const void* table,
                                      const void* stash, void* ec,
                                      void* stream, int64_t device,
                                      int64_t n_seg, int64_t P, int64_t s,
                                      int64_t S, int64_t segs,
                                      int64_t main_buckets,
                                      int64_t stash_buckets, int64_t bucket,
                                      int64_t aux_bits) {
  cudaSetDevice((int)device);
  if (n_seg <= 0) return (int)cudaGetLastError();
  if (P < 1 || P > 1024 || s < 2 || S != (P + s - 1) / s + 1 || segs < 1 ||
      segs > 32 || segs * S > kMaxSlots || aux_bits < 1 || aux_bits > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{n_seg, (int)P, (int)s, (int)S, (int)segs,
                 (uint32_t)(main_buckets - 1), (uint32_t)(stash_buckets - 1),
                 (int)aux_bits};
  auto st = (cudaStream_t)stream;
  const int d = (int)device;
  switch (bucket) {
    case 1: return launch<1>(hi, lo, valid, table, stash, ec, st, d, p);
    case 2: return launch<2>(hi, lo, valid, table, stash, ec, st, d, p);
    case 4: return launch<4>(hi, lo, valid, table, stash, ec, st, d, p);
    case 8: return launch<8>(hi, lo, valid, table, stash, ec, st, d, p);
    case 16: return launch<16>(hi, lo, valid, table, stash, ec, st, d, p);
    case 32: return launch<32>(hi, lo, valid, table, stash, ec, st, d, p);
    default: return (int)cudaErrorInvalidValue;
  }
}
