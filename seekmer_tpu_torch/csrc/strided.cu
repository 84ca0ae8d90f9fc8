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
// boundaries); its own rows (valid, the sampled hi and lo in; ec out) are
// read and written once. A lookup round of `seekmer::warp_lookup`
// (lookup.cuh, K2's routine) costs its round trips however few of its 32
// lanes hold a key, and a warp has one round in flight, so the design
// keeps the rounds full and puts nothing else on a warp's chain of
// device-memory round trips:
//
//   - a warp owns tiles of `segs` consecutive segments (P windows each; a
//     pair's mates are two segments of one (B, 2P) row, so coverage never
//     crosses the mate boundary) and walks them grid-stride; the plan
//     (ops/strided_cuda.py `strided_plan`) takes the largest tile that
//     fits a warp's share of 196 KB of shared memory at 4 blocks an SM
//     (L1 keeps 60 KB) and leaves every warp the card holds a tile, and
//     lays out each warp's shared memory; no block barrier, no global
//     atomics, 64 registers and no spill;
//   - staging: a tile's valid bytes are one contiguous run, copied into the
//     warp's shared memory by 16-byte `cp.async` from the 16-byte chunk
//     that holds its first byte (a chunk that holds a byte of the tensor
//     lies in its allocation), and each sampled window's hi and lo by a
//     4-byte `cp.async`. Two buffers: the next tile's copies are issued
//     before the current tile's work, so their latency hides behind it,
//     and no register holds them in flight;
//   - sampled columns 0, s, 2s, ... below P, then P - 1 (always, as the JAX
//     package samples them): each 32 sampled lanes of the tile ballot their
//     staged validity and append their slot to the warp's queue; every 32
//     queued keys are one lookup round, whose 3-state result (the matched
//     slot's ecaux, ec << aux_bits | d, else < 0) is kept a slot;
//   - then the fill, from shared memory: where P % 4 == 0 a lane takes 4
//     windows (a 16-byte group, which never crosses a segment) of the
//     tile's flat run, 128 a warp step, and writes their ec as one int4;
//     otherwise one window a lane. A window takes the left sample's EC
//     when it hit and its run length reaches the window, else the right
//     one's; a sampled window keeps its own result; the rest, when valid,
//     are needy: they are written -1 and push their offset in `ec` to the
//     same queue, in window order (a lane's place from ballots of the
//     lanes' counts), and their round writes them;
//   - the queue, a stack, holds only tags: a slot (>= 0) or a needy window
//     (~offset). A round takes the last 32 (no tag moves), reads a slot's
//     key from the staged copy and gathers the needy windows' hi and lo,
//     32 independent loads together. The needy
//     keys left at a tile's end are not looked up in a partial round: they
//     ride in the next tile's sampled rounds, so a tile ends in one partial
//     round (its samples' last, before its fill reads the slots), not two.
//     The warp's last tile drains the queue.
//
// Results equal ops/probe.py `lookup_ecs_strided`, itself equal to the
// JAX function: ec = ecaux >> aux_bits (arithmetic shift), d = ecaux &
// mask, a sample that missed or is invalid covers nothing.

#include <algorithm>

#include "lookup.cuh"

namespace {

constexpr int kWarps = 8;      // warps a block
constexpr int kMinBlocks = 4;  // <= 64 registers, as K2
constexpr int kQueue = 160;    // < 32 left + 128 pushed (a 4-window step)
constexpr int kSmemBlock = 232448;  // shared memory a block can use (227 KB)

// The carve of a warp's shared memory, in bytes from its start, as
// ops/strided_cuda.py `strided_plan` lays it out: staging buffer b at
// b * stage (its valid chunks at 0, the sampled hi at hi, lo at lo), then
// the slots and the queue. The launcher checks that each part fits.
struct Carve {
  int stage, hi, lo, slot, queue, warp;
};

struct Params {
  int n_seg, tiles;  // segments (rows x segments a row), tiles of segs
  int P, s, S, segs;
  uint32_t inv_P, inv_s, inv_S;  // ceil(2^32 / d), 0 for d = 1: div_by
  Carve cv;
  uint32_t main_mask, stash_mask;
  int aux_bits;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for every copy group of this thread but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x / d for 0 <= x, with inv = ceil(2^32 / d) (d >= 2; inv = 0 stands for
// d = 1): exact while x d < 2^32 (x below 2^22 and d at most 1,024 here),
// a multiply in place of the ~20 instructions of a division by a value
// known only at run time.
__device__ __forceinline__ int div_by(int x, uint32_t inv) {
  return inv ? (int)__umulhi((uint32_t)x, inv) : x;
}

// The sampled column of a tile's sample i: t = i / S its segment.
__device__ __forceinline__ int sample_col(int i, int t, const Params& p) {
  return min((i - t * p.S) * p.s, p.P - 1);  // the last: P - 1
}

// The warp's shared memory is addressed by byte offsets from `smem` (32-bit
// shared addresses, not 64-bit generic pointers, to spare registers).
extern __shared__ __align__(16) uint8_t smem[];

__device__ __forceinline__ int32_t* at32(int off) {
  return reinterpret_cast<int32_t*>(smem + off);
}

// The thread's lane; its warp's first byte of shared memory and the
// grid's warps, read afresh at each use (volatile: never held in a
// register across a lookup round, where the round's own registers are
// needed).
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ int warp_at(const Params& p) {
  int r;
  asm volatile("{\n.reg .u32 t;\nmov.u32 t, %%tid.x;\nshr.u32 %0, t, 5;\n}"
               : "=r"(r));
  return r * p.cv.warp;
}

__device__ __forceinline__ int grid_warps() {
  int r;
  asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(r));
  return r * kWarps;
}

// Issues the copies of the tile whose first window is `base` (T segments)
// into the staging buffer at `buf`: its valid run from the 16-byte chunk
// holding its first byte, and its sampled windows' hi and lo.
__device__ __forceinline__ void stage_tile(
    int base, int T, int buf, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ lo, const uint8_t* __restrict__ valid,
    const Params& p) {
  const uintptr_t a = (uintptr_t)(valid + base);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int chunks = (int)((a + (uintptr_t)T * p.P - a0 + 15) >> 4);
  for (int c = lane_id(); c < chunks; c += 32) {
    cp_async16(smem + buf + 16 * c, reinterpret_cast<const int4*>(a0) + c);
  }
  for (int i = lane_id(); i < T * p.S; i += 32) {
    const int t = div_by(i, p.inv_S);
    const int x = base + t * p.P + sample_col(i, t, p);
    cp_async4(at32(buf + p.cv.hi) + i, hi + x);
    cp_async4(at32(buf + p.cv.lo) + i, lo + x);
  }
}

// Pushes each lane's tags to the warp's queue in lane order: `bits` (of
// W) says which of the needy tags ~(w + k), k < W, a lane pushes for its
// windows w.. (tag0 = ~w, so ~(w + k) = tag0 - k), or with W = 0 the lane
// pushes tag0 alone when bits is 1. A lane's place is the count of the
// lanes before it, summed from one ballot a bit of the counts. Returns
// the new length.
template <int W>
__device__ __forceinline__ int push(int n, uint32_t bits, int32_t tag0,
                                   const Params& p) {
  const int cnt = __popc(bits);
  const uint32_t before = (1u << lane_id()) - 1;
  int rank = 0, total = 0;
#pragma unroll
  for (int b = 0; (1 << b) <= (W ? W : 1); ++b) {
    const uint32_t bal = __ballot_sync(seekmer::kFull, (cnt >> b) & 1);
    rank += __popc(bal & before) << b;
    total += __popc(bal) << b;
  }
  int32_t* q = at32(warp_at(p) + p.cv.queue) + n + rank;
  if constexpr (W == 0) {
    if (bits) *q = tag0;
  } else {
    for (; bits; bits &= bits - 1) *q++ = tag0 - (__ffs(bits) - 1);
  }
  __syncwarp();
  return n + total;
}

__device__ __forceinline__ int32_t ec_of(int32_t m, int aux_bits) {
  return m >= 0 ? m >> aux_bits : -1;
}

// One lookup round of the last min(n, 32) tags of the warp's queue (a
// stack: no tag moves): a slot's key is read from the staged copy in
// staging buffer b and its result kept in the warp's slots; a needy
// window's key is gathered from hi and lo, and its EC written to `ec`.
// Returns the queue's new length.
template <int G>
__device__ __forceinline__ int flush(int n, int b,
                                     const int32_t* __restrict__ hi,
                                     const int32_t* __restrict__ lo,
                                     int32_t* __restrict__ ec,
                                     const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ stash,
                                     const Params& p) {
  const int top = max(n - 32, 0);  // the round takes [top, n)
  const bool v = lane_id() < n - top;
  int32_t khi = 0, klo = 0;
  if (v) {
    const int32_t tag = at32(warp_at(p) + p.cv.queue)[top + lane_id()];
    if (tag >= 0) {
      const int buf = warp_at(p) + b * p.cv.stage;
      khi = at32(buf + p.cv.hi)[tag];
      klo = at32(buf + p.cv.lo)[tag];
    } else {
      khi = __ldg(hi + ~tag);
      klo = __ldg(lo + ~tag);
    }
  }
  const int32_t m = seekmer::warp_lookup<G>(v, khi, klo, table, stash,
                                            p.main_mask, p.stash_mask);
  if (v) {  // the tag again, read after the round rather than held in it
    const int32_t tag = reinterpret_cast<volatile int32_t*>(
        at32(warp_at(p) + p.cv.queue))[top + lane_id()];
    if (tag >= 0) {
      at32(warp_at(p) + p.cv.slot)[tag] = m;
    } else {
      ec[~tag] = ec_of(m, p.aux_bits);
    }
  }
  __syncwarp();  // the next appends overwrite [top, n)
  return top;
}

// The fill of one window at column col of a segment whose slots are sl:
// returns its ec (-1 when invalid or needy) and sets `need` for a valid
// window that no sample covers.
__device__ __forceinline__ int32_t fill_one(const int32_t* sl, int col,
                                            bool v, bool& need,
                                            const Params& p) {
  const int P = p.P, s = p.s;
  const int gap = div_by(col, p.inv_s), pl = gap * s;
  const int32_t ml = sl[gap];
  need = false;
  int32_t val;
  if (col == P - 1) {
    val = ec_of(sl[p.S - 1], p.aux_bits);
  } else if (col == pl) {
    val = ec_of(ml, p.aux_bits);
  } else {
    const int32_t mr = sl[gap + 1];
    const int pr = min(pl + s, P - 1);
    const int32_t dmask = (1 << p.aux_bits) - 1;
    const bool cov_l = ml >= 0 && (ml & dmask) >= col - pl;
    const bool cov_r = mr >= 0 && (mr & dmask) >= pr - col;
    val = cov_l ? ml >> p.aux_bits : cov_r ? mr >> p.aux_bits : -1;
    need = v && !cov_l && !cov_r;
  }
  return v && !need ? val : -1;
}

// x, which the compiler must treat as unknown: what is derived from it is
// recomputed where it is used rather than held in a register.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Segments of tile `tile`: segs, or fewer for the last.
__device__ __forceinline__ int tile_segs(int tile, const Params& p) {
  return min(p.segs, p.n_seg - tile * p.segs);
}

// The shared byte of window 0 of tile `tile` in staging buffer B.
template <int B>
__device__ __forceinline__ int staged_valid(int tile,
                                            const uint8_t* valid,
                                            const Params& p) {
  return warp_at(p) + B * p.cv.stage +
         (int)((uintptr_t)(valid + tile * p.segs * p.P) & 15);
}

// One tile's work, its copies in staging buffer B (a template parameter:
// the buffer's offsets are constants in each form's code): issue the
// copies of the warp's next tile into the other buffer, wait for this
// tile's, the sampled rounds, the fill. Takes and returns the queue's
// length, carried from tile to tile.
template <int G, bool V4, int B>
__device__ __forceinline__ int tile_work(
    int tile, int n, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ lo, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ table, const int32_t* __restrict__ stash,
    int32_t* __restrict__ ec, const Params& p) {
  const int P = p.P, S = p.S;
  const int next = tile + grid_warps();
  if (next < p.tiles) {  // the next tile's copies, before this one's work
    stage_tile(next * p.segs * P, tile_segs(next, p),
               warp_at(p) + (B ^ 1) * p.cv.stage, hi, lo, valid, p);
  }
  cp_async_commit();
  cp_async_wait_prior();
  __syncwarp();  // every lane's copies of this tile have landed

  // sampled windows, 32 lanes a step: valid ones to the queue, behind the
  // needy windows the last tile left
  for (int q0 = 0; q0 < tile_segs(opaque(tile), p) * S; q0 += 32) {
    const int tl = opaque(tile);  // nothing derived from it is hoisted
    const int i = q0 + lane_id();
    bool v = false;
    if (i < tile_segs(tl, p) * S) {
      const int t = div_by(i, p.inv_S);
      v = smem[staged_valid<B>(tl, valid, p) + t * P +
               sample_col(i, t, p)];
      at32(warp_at(p) + p.cv.slot)[i] = -1;  // an invalid one covers nothing
    }
    n = push<0>(n, v, i, p);
    if (n >= 32) n = flush<G>(n, B, hi, lo, ec, table, stash, p);
  }
  if (n > 0) {  // the slots must be whole before the fill reads them
    n = flush<G>(n, B, hi, lo, ec, table, stash, p);
  }

  // the fill over the tile's flat run of T P windows, W a lane (W = 4 when
  // P % 4 == 0: a 16-byte group, which never crosses a segment, written as
  // one int4); a needy window is written -1 and queues its offset in ec
  constexpr int W = V4 ? 4 : 1;
  for (int x0 = 0; x0 < tile_segs(opaque(tile), p) * P; x0 += 32 * W) {
    const int tl = opaque(tile);
    const int base = tl * p.segs * P;  // the tile's first window
    const int x = x0 + W * lane_id();
    uint32_t need = 0;  // bit k: window x + k is needy
    if (x < tile_segs(tl, p) * P) {
      const int sv = staged_valid<B>(tl, valid, p);
      const int t = div_by(x, p.inv_P), col = x - t * P;
      const int32_t* sl = at32(warp_at(p) + p.cv.slot) + t * S;
      int32_t o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        bool nk;
        o[k] = fill_one(sl, col + k, smem[sv + x + k], nk, p);
        need |= (uint32_t)nk << k;
      }
      if constexpr (V4) {
        *reinterpret_cast<int4*>(ec + base + x) =
            make_int4(o[0], o[1], o[2], o[3]);
      } else {
        ec[base + x] = o[0];
      }
    }
    n = push<W>(n, need, ~(base + x), p);
    while (n >= 32) n = flush<G>(n, B, hi, lo, ec, table, stash, p);
  }
  __syncwarp();  // the next tile overwrites the slots, then this buffer
  return n;
}

// V4: 4 windows a lane (P % 4 == 0); else one. Window offsets are int:
// the launcher takes fewer than 2^31 windows. A warp keeps its tile, its
// queue's length and loop counters in registers; the rest is recomputed
// where it is used, so that a lookup round has the registers it needs.
template <int G, bool V4>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
strided_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ stash, int32_t* __restrict__ ec,
               Params p) {
  int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);  // uniform in a warp
  int n = 0;  // the queue's length, carried from tile to tile
  if (tile < p.tiles) {
    stage_tile(tile * p.segs * p.P, tile_segs(tile, p), warp_at(p), hi, lo,
               valid, p);
  }
  cp_async_commit();
  // the warp's tiles in turn through buffers 0 and 1: its j-th tile is
  // first + j warps with first < warps, so j = tile / warps
  for (; tile < p.tiles; tile += grid_warps()) {
    n = (tile / grid_warps()) & 1
            ? tile_work<G, V4, 1>(tile, n, hi, lo, valid, table, stash, ec, p)
            : tile_work<G, V4, 0>(tile, n, hi, lo, valid, table, stash, ec,
                                  p);
  }
  if (n > 0) flush<G>(n, 0, hi, lo, ec, table, stash, p);
}

template <int G, bool V4>
int launch(const void* hi, const void* lo, const void* valid,
           const void* table, const void* stash, void* ec,
           cudaStream_t stream, int device, const Params& p) {
  const size_t smem = (size_t)kWarps * p.cv.warp;
  auto kernel = strided_kernel<G, V4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWarps * 32, smem);
  const int grid = (int)std::max<int64_t>(
      1, std::min<int64_t>(seekmer::grid_for(p.tiles, kWarps),
                           (int64_t)sms * std::max(per_sm, 1)));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid,
      (const int32_t*)table, (const int32_t*)stash, (int32_t*)ec, p);
  return (int)cudaGetLastError();
}

}  // namespace

// n_seg segments of P windows, laid end to end (a (B, W) row of W = g P
// windows is g segments); S = ceil(P / s) + 1 sampled columns a segment,
// segs segments a warp's tile and the carve of a warp's shared memory
// (ops/strided_cuda.py `strided_plan`); vec4: 4 windows a lane, which
// needs P % 4 == 0 (ec is then 16-byte aligned at every group).
extern "C" int seekmer_strided_lookup(
    const void* hi, const void* lo, const void* valid, const void* table,
    const void* stash, void* ec, void* stream, int64_t device, int64_t n_seg,
    int64_t P, int64_t s, int64_t S, int64_t segs, int64_t main_buckets,
    int64_t stash_buckets, int64_t bucket, int64_t aux_bits, int64_t vec4,
    int64_t stage_at, int64_t hi_at, int64_t lo_at, int64_t slot_at,
    int64_t queue_at, int64_t warp_bytes) {
  cudaSetDevice((int)device);
  if (n_seg <= 0) return (int)cudaGetLastError();
  const int64_t TS = segs * S;
  if (P < 1 || P > 1024 || s < 2 || S != (P + s - 1) / s + 1 || segs < 1 ||
      n_seg * P >= (int64_t)1 << 31 || aux_bits < 1 || aux_bits > 30 ||
      (vec4 && (P % 4 || (uintptr_t)ec % 16)) || hi_at % 16 ||
      hi_at < ((segs * P + 30) & ~15) || lo_at - hi_at < 4 * TS ||
      stage_at - lo_at < 4 * TS || stage_at % 16 || slot_at < 2 * stage_at ||
      queue_at - slot_at < 4 * TS || warp_bytes - queue_at < 4 * kQueue ||
      warp_bytes % 16 || warp_bytes * kWarps > kSmemBlock) {
    return (int)cudaErrorInvalidValue;
  }
  // a stride beyond P samples what P does (columns 0 and P - 1)
  const int64_t se = std::min<int64_t>(s, std::max<int64_t>(P, 2));
  auto inv = [](int64_t d) {
    return d > 1 ? (uint32_t)((((int64_t)1 << 32) + d - 1) / d) : 0u;
  };
  const Params p{(int)n_seg, (int)((n_seg + segs - 1) / segs), (int)P,
                 (int)se, (int)S, (int)segs, inv(P), inv(se), inv(S),
                 Carve{(int)stage_at, (int)hi_at, (int)lo_at, (int)slot_at,
                       (int)queue_at, (int)warp_bytes},
                 (uint32_t)(main_buckets - 1), (uint32_t)(stash_buckets - 1),
                 (int)aux_bits};
  auto st = (cudaStream_t)stream;
  const int d = (int)device;
#define SEEKMER_STRIDED(G)                                                 \
  case G:                                                                  \
    return vec4 ? launch<G, true>(hi, lo, valid, table, stash, ec, st, d, \
                                  p)                                       \
                : launch<G, false>(hi, lo, valid, table, stash, ec, st, d, \
                                   p);
  switch (bucket) {
    SEEKMER_STRIDED(1)
    SEEKMER_STRIDED(2)
    SEEKMER_STRIDED(4)
    SEEKMER_STRIDED(8)
    SEEKMER_STRIDED(16)
    SEEKMER_STRIDED(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEEKMER_STRIDED
}
