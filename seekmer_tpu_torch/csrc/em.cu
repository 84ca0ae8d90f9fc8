// K4: the whole dense EM fixed point in one launch, on Hopper's tensor cores.
//
// Replaces seekmer_tpu/ops/em_pallas.py `_em_kernel` (R > 1) and
// `_em_kernel_r1` (R = 1). Over the dense 0/1 membership M [E, T] one
// iteration is
//
//     x = alpha * inv_eff;  denom = x M^T;  r = n / denom (0 where denom = 0)
//     alpha' = x * (r M)
//
// in blocks of check_every - 1 raw steps and one monitored step, stopping
// when any transcript is active (alpha' > count_floor), the largest relative
// change over active entries is below rel_tol and at least min_iters ran, or
// at max_iters: the schedule of em.run_blocked_fixed_point and the oracle.
//
// What bounds it on Hopper, and what the design does about it:
//
//  * The products, 4 R E T flops an iteration. M is exactly 0/1, so a
//    TF32 product by M is exact and only the dense operand (x in phase 1,
//    r in phase 2) needs more than TF32: a = a_hi + a_lo, each rounded to
//    TF32 (cvt.rna), and a_hi M + a_lo M with FP32 accumulation on
//    mma.sync m16n8k8 gives FP32-grade sums from two products (3xTF32
//    needs three; one TF32 product fails the smoke's mass bound). This is
//    what JAX's Precision.HIGHEST on the TPU's matrix unit becomes.
//  * M on chip. Each block packs its slices of M into bits once, in the
//    prologue, already in mma fragment order (one 64-bit word per 8 x 8
//    block: bit l of .x is lane l's b0, of .y its b1, expanded to 0.0f /
//    1.0f in registers), and keeps them in shared memory for the whole
//    launch: the rows of its ECs for phase 1, the columns of its
//    transcripts for phase 2. No iteration reads M from memory; the dense
//    gate (E T <= 2M entries) keeps both slices within 32 KB at 16 blocks.
//  * Barriers per replicate group. Replicate rows meet only at the
//    convergence test: denom[r, .] needs only x[r, .], back[r, .] only
//    r[r, .]. A group of 16 replicate rows (the mma's m) runs on one
//    thread-block cluster (16 blocks where the card schedules them).
//    Block b owns ECs [b SE, (b+1) SE) and transcripts [b ST, (b+1) ST):
//    phase 1 computes its r, phase 2 its alpha' and x, and its epilogue
//    stores them into the shared memory of every block of the cluster
//    (distributed shared memory), so after a cluster.sync() each block
//    holds the whole group's x (or r) for the next phase. Two cluster
//    syncs an iteration; the grid meets only at the monitored step, once
//    every check_every iterations (the TPU kernel's `while` over the whole
//    state becomes one grid.sync() per block of iterations, where a grid-wide
//    product would pay two an iteration). The convergence terms go by atomicMax
//    (non-negative floats order as their bits) and atomicOr into one of
//    three slot sets; after the grid sync every block reads the same set
//    and takes the same exit decision. Block 0 clears the set the next
//    block of iterations will use: three rotate because a set read after
//    grid sync k must stay until every block has passed sync k + 1. Where
//    more groups exist than clusters fit on the card, each cluster walks
//    several in turn; a group's alpha waits in the output between blocks
//    of iterations.
//  * Depth chunks. Where the whole x and r do not fit beside the rest,
//    blocks keep only their own slices and each phase gathers its depth in
//    chunks of KC columns from the other blocks; outputs go in rounds of
//    8 n-tiles a warp team. Every system the dense gate admits runs here:
//    none is handed to the plain version.
//  * The launch is cooperative and clustered at once (cudaLaunchKernelEx
//    with both attributes; the card accepts the pair), sized from
//    cudaOccupancyMaxActiveClusters, so cg::this_grid().sync() serves.
//
// Inside a block, 8 warps split each phase's depth (split-k) in teams of
// WARPS / P warps, P n-tile groups at once; the partial tiles are summed
// through shared memory in warp order. Each warp sums its depth in a fixed
// order and no float atomics touch the products, so two runs give the
// same bits. R = 1 runs the same code with one group: `_em_kernel_r1`
// existed because the TPU's matrix unit wasted 7 of its 8 result rows at
// R = 1; here 15 of the mma's 16 rows idle.
//
// What bounds it as measured (PERF.md; E 1,396, T 1,000, R 100, ~21 us
// an iteration on an H100): the products, about half of block 0's cycles,
// then the epilogues that store each block's slice into the cluster's
// shared memory, over a quarter. One block an SM is set by the resident
// layout's shared memory, not by registers. The work itself is far
// smaller: M is sparse, and the dense products do every zero entry too.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 16;            // replicate rows of a group, the mma's m
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NG = 8;               // n-tiles of 8 columns a warp holds at once
constexpr int RED_LD = 8 * NG + 4;  // row stride of the reduction buffer
constexpr uint32_t ONE = 0x3f800000u;  // 1.0f, exact in TF32
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* M;        // [E, T] 0/1 membership
  const float* n;        // [R, E] counts
  const float* inv_eff;  // [T]
  const float* alpha0;   // [R, T]
  float* alpha;          // [R, T] output; each group's iterate between blocks
  unsigned int* sync;    // [0..5] three slot sets {max-rel bits, any active}
  int* iters;            // [1] output
  int E, T, R, C, max_iters, min_iters;
  int SE, ST;  // ECs and transcripts owned by each block of a cluster (x 8)
  int KC;      // 0: x and r resident in full; else depth chunk width (x 8)
  int groups;  // replicate groups of 16 rows
  float rel_tol, abs_floor, count_floor;
};

// Shared memory of one block. Resident (KC == 0): x [16][CS ST + 4] and
// r [16][CS SE + 4] hold the whole group's operands, each block's slice
// written by its owner into every block of the cluster. Chunked: x and r
// hold only this block's slices, and each phase gathers the depth into
// chunk [16][KC + 4] from the other blocks.
struct Smem {
  float* x;
  float* r;
  float* chunk;  // chunked mode only
  float* red;    // [WARPS][16][RED_LD] partial tiles
  float* n;      // [16][SE] this block's counts of the group
  float* alpha;  // [16][ST] this block's alpha of the group
  float* inv;    // [ST] this block's inv_eff
  uint2* bits1;  // [CS ST / 8][SE / 8] phase 1: B(k, n) = M[e0 + n, t0 + k]
  uint2* bits2;  // [CS SE / 8][ST / 8] phase 2: B(k, n) = M[e0 + k, t0 + n]
  int ldx, ldr, offx, offr;
};

// Bytes of shared memory for a plan; every float array a multiple of 16
// bytes so float4 access stays aligned, the bit arrays last.
__host__ __device__ inline size_t smem_bytes(int CS, int SE, int ST, int KC) {
  const size_t xr = KC == 0 ? (size_t)ROWS * (CS * ST + 4 + CS * SE + 4)
                            : (size_t)ROWS * (ST + SE + KC + 4);
  return 4 * (xr + (size_t)WARPS * ROWS * RED_LD + (size_t)ROWS * SE +
              (size_t)ROWS * ST + ST) +
         8 * ((size_t)(CS * ST / 8) * (SE / 8) + (size_t)(CS * SE / 8) *
                                                      (ST / 8));
}

__device__ __forceinline__ Smem carve(unsigned char* base, const Params& p,
                                      int CS, int rank) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  if (p.KC == 0) {
    s.ldx = CS * p.ST + 4;
    s.ldr = CS * p.SE + 4;
    s.offx = rank * p.ST;
    s.offr = rank * p.SE;
  } else {
    s.ldx = p.ST;
    s.ldr = p.SE;
    s.offx = s.offr = 0;
  }
  s.x = f;
  s.r = s.x + ROWS * s.ldx;
  s.chunk = s.r + ROWS * s.ldr;
  s.red = s.chunk + (p.KC == 0 ? 0 : ROWS * (p.KC + 4));
  s.n = s.red + WARPS * ROWS * RED_LD;
  s.alpha = s.n + ROWS * p.SE;
  s.inv = s.alpha + ROWS * p.ST;
  s.bits1 = reinterpret_cast<uint2*>(s.inv + p.ST);
  s.bits2 = s.bits1 + (CS * p.ST / 8) * (p.SE / 8);
  return s;
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// d += A B on one m16n8k8 TF32 tile, FP32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Write v at buf[i..i+3] of this block (chunked mode) or of every block of
// the cluster (resident mode), starting with the next rank so the blocks'
// stores spread over the cluster.
__device__ __forceinline__ void put4(const cg::cluster_group& cluster,
                                     float* buf, int i, float4 v, int CS,
                                     int rank, bool resident) {
  if (!resident) {
    *reinterpret_cast<float4*>(buf + i) = v;
    return;
  }
  for (int j = 1; j <= CS; ++j) {
    const int peer = rank + j < CS ? rank + j : rank + j - CS;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(buf, peer) + i) = v;
  }
}

// acc[j] += A[16 x 8 ks] B_j for the warp's depth steps [k_lo, k_hi) and
// CNT n-tiles: a = a_hi + a_lo in TF32, B expanded from its bits.
template <int CNT>
__device__ __forceinline__ void mma_span(const float* a_top,
                                         const float* a_bot,
                                         const uint2* brow, int NT, int k_lo,
                                         int k_hi, int lane,
                                         float (&acc)[NG][4]) {
#pragma unroll 2
  for (int ks = k_lo; ks < k_hi; ++ks) {
    const float f0 = a_top[8 * ks], f1 = a_bot[8 * ks];
    const float f2 = a_top[8 * ks + 4], f3 = a_bot[8 * ks + 4];
    uint2 m[CNT];
#pragma unroll
    for (int j = 0; j < CNT; ++j) m[j] = brow[(size_t)ks * NT + j];
    const uint32_t h0 = to_tf32(f0), h1 = to_tf32(f1);
    const uint32_t h2 = to_tf32(f2), h3 = to_tf32(f3);
    const uint32_t l0 = to_tf32(f0 - __uint_as_float(h0));
    const uint32_t l1 = to_tf32(f1 - __uint_as_float(h1));
    const uint32_t l2 = to_tf32(f2 - __uint_as_float(h2));
    const uint32_t l3 = to_tf32(f3 - __uint_as_float(h3));
#pragma unroll
    for (int j = 0; j < CNT; ++j) {
      const uint32_t b0 = ((m[j].x >> lane) & 1u) ? ONE : 0u;
      const uint32_t b1 = ((m[j].y >> lane) & 1u) ? ONE : 0u;
      mma(acc[j], h0, h1, h2, h3, b0, b1);
      mma(acc[j], l0, l1, l2, l3, b0, b1);
    }
  }
}

// Pack this block's slices of M into fragment-ordered bits. Each warp reads
// 8 rows x 32 columns of M (coalesced along T) into 8 ballots, and lanes
// 0-3 each assemble one 8 x 8 block's word from them.
__device__ void pack_bits(const Params& p, const Smem& s, int CS, int rank) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NT1 = p.SE / 8, KS1 = CS * p.ST / 8;
  const int NT2 = p.ST / 8, KS2 = CS * p.SE / 8;
  // phase 1: rows e = rank SE + 8 nt + i are the n index, columns the k
  const int Q1 = (KS1 + 3) / 4;
  for (int tile = warp; tile < NT1 * Q1; tile += WARPS) {
    const int nt = tile % NT1, q = tile / NT1;
    const int t = 32 * q + lane;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = rank * p.SE + 8 * nt + i;
      const float v = (e < p.E && t < p.T) ? __ldg(p.M + (size_t)e * p.T + t)
                                           : 0.f;
      w[i] = __ballot_sync(FULL, v != 0.f);
    }
    const int ks = 4 * q + lane;
    if (lane < 4 && ks < KS1) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo |= ((w[i] >> (8 * lane + k)) & 1u) << (4 * i + k);
          hi |= ((w[i] >> (8 * lane + 4 + k)) & 1u) << (4 * i + k);
        }
      }
      s.bits1[(size_t)ks * NT1 + nt] = make_uint2(lo, hi);
    }
  }
  // phase 2: rows e = 8 ks + i are the k index, columns (this block's
  // transcripts) the n index
  const int Q2 = (NT2 + 3) / 4;
  for (int tile = warp; tile < KS2 * Q2; tile += WARPS) {
    const int ks = tile % KS2, q = tile / KS2;
    const int tl = 32 * q + lane, t = rank * p.ST + tl;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = 8 * ks + i;
      const float v = (e < p.E && tl < p.ST && t < p.T)
                          ? __ldg(p.M + (size_t)e * p.T + t)
                          : 0.f;
      w[i] = __ballot_sync(FULL, v != 0.f);
    }
    const int nt = 4 * q + lane;
    if (lane < 4 && nt < NT2) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          lo |= ((w[k] >> (8 * lane + n)) & 1u) << (4 * n + k);
          hi |= ((w[k + 4] >> (8 * lane + n)) & 1u) << (4 * n + k);
        }
      }
      s.bits2[(size_t)ks * NT2 + nt] = make_uint2(lo, hi);
    }
  }
}

// Chunked mode: copy depth columns [c0, c0 + kc) of the cluster's operand
// (block b's slice src[16][S] holds columns [b S, (b+1) S)) into
// chunk[16][KC + 4], four loads in flight a thread.
__device__ __forceinline__ void gather(const cg::cluster_group& cluster,
                                       float* src, int S, int c0, int kc,
                                       float* chunk, int LDA) {
  const int nv = kc / 4, total = ROWS * nv;
  for (int base = threadIdx.x; base < total; base += 4 * THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        const int row = i / nv, col = c0 + 4 * (i % nv);
        const float* rp = cluster.map_shared_rank(src, col / S);
        v[u] = *reinterpret_cast<const float4*>(rp + row * S + col % S);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        *reinterpret_cast<float4*>(chunk + (i / nv) * LDA + 4 * (i % nv)) =
            v[u];
      }
    }
  }
}

// One phase for replicate group g. PHASE 1: denom[16, SE] = x M^T over the
// depth T, epilogue r = n / denom. PHASE 2: back[16, ST] = r M over the
// depth E, epilogue alpha' = x * back, x = alpha' * inv_eff, and on the
// monitored step the convergence terms. The block's n-tiles are cut into
// groups of at most NG; P groups run at once, each on WARPS / P warps that
// split its depth.
template <int PHASE>
__device__ void run_phase(const Params& p, const cg::cluster_group& cluster,
                          const Smem& s, int CS, int rank, int g, int step,
                          unsigned& max_rel, unsigned& any) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const bool resident = p.KC == 0;
  const int S_in = PHASE == 1 ? p.ST : p.SE;
  const int S_out = PHASE == 1 ? p.SE : p.ST;
  const int NT = S_out / 8, Dp = CS * S_in;
  const uint2* bits = PHASE == 1 ? s.bits1 : s.bits2;
  float* opnd = PHASE == 1 ? s.x : s.r;  // this phase's operand
  const float* A = resident ? opnd : s.chunk;
  const int lda = resident ? (PHASE == 1 ? s.ldx : s.ldr) : p.KC + 4;
  const int kc_max = resident ? Dp : p.KC;
  const int nchunks = (Dp + kc_max - 1) / kc_max;
  const int want = (NT + NG - 1) / NG;
  int P = 1;
  while (2 * P <= min(want, WARPS)) P *= 2;
  const int rounds = (want + P - 1) / P;
  const int per = (NT + P * rounds - 1) / (P * rounds);
  const int KW = WARPS / P, team = warp % P, kw = warp / P;
  if (!resident && nchunks == 1) {
    gather(cluster, opnd, S_in, 0, Dp, s.chunk, lda);
    __syncthreads();
  }
  for (int rd = 0; rd < rounds; ++rd) {
    const int nt0 = min((rd * P + team) * per, NT);
    const int cnt = min(per, NT - nt0);
    float acc[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * kc_max, kc = min(kc_max, Dp - c0);
      if (nchunks > 1) {
        __syncthreads();
        gather(cluster, opnd, S_in, c0, kc, s.chunk, lda);
        __syncthreads();
      }
      const int ksn = kc / 8;
      const int k_lo = ksn * kw / KW, k_hi = ksn * (kw + 1) / KW;
      const float* a_top = A + gid * lda + tig;
      const float* a_bot = a_top + 8 * lda;
      const uint2* brow = bits + (size_t)(c0 / 8) * NT + nt0;
      switch (cnt) {
#define SPAN(c)                                                       \
  case c:                                                             \
    if constexpr (c <= NG)                                            \
      mma_span<c>(a_top, a_bot, brow, NT, k_lo, k_hi, lane, acc);     \
    break;
        SPAN(1) SPAN(2) SPAN(3) SPAN(4) SPAN(5) SPAN(6) SPAN(7) SPAN(8)
#undef SPAN
        default:
          break;
      }
    }
    // the warps' partial tiles, summed in warp order
    float* red = s.red + warp * ROWS * RED_LD;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (j < cnt) {
        const int c = 8 * j + 2 * tig;
        red[gid * RED_LD + c] = acc[j][0];
        red[gid * RED_LD + c + 1] = acc[j][1];
        red[(gid + 8) * RED_LD + c] = acc[j][2];
        red[(gid + 8) * RED_LD + c + 1] = acc[j][3];
      }
    }
    __syncthreads();
    const int w4 = 2 * per, span = ROWS * w4;  // float4s of a row
    for (int i = tid; i < P * span; i += THREADS) {
      const int tm = i / span, row = (i % span) / w4, col = 4 * (i % w4);
      const int nt_first = min((rd * P + tm) * per, NT);
      if (col >= 8 * min(per, NT - nt_first)) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < KW; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            s.red + ((k * P + tm) * ROWS + row) * RED_LD + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      const int o = nt_first * 8 + col, rg = g * ROWS + row;
      if (PHASE == 1) {
        const float4 cn =
            *reinterpret_cast<const float4*>(s.n + row * p.SE + o);
        const float4 rv = make_float4(sum.x > 0.f ? cn.x / sum.x : 0.f,
                                      sum.y > 0.f ? cn.y / sum.y : 0.f,
                                      sum.z > 0.f ? cn.z / sum.z : 0.f,
                                      sum.w > 0.f ? cn.w / sum.w : 0.f);
        put4(cluster, s.r, row * s.ldr + s.offr + o, rv, CS, rank, resident);
      } else {
        const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
        const float* xo = s.x + row * s.ldx + s.offx + o;
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = rank * p.ST + o + c;
          xv[c] = 0.f;
          if (t < p.T && rg < p.R) {
            const float a_new = xo[c] * sv[c];
            float& a_old = s.alpha[row * p.ST + o + c];
            if (step == p.C - 1) {
              if (a_new > p.count_floor) {
                const float rel =
                    fabsf(a_new - a_old) / (a_new + p.abs_floor);
                max_rel = max(max_rel, __float_as_uint(rel));
                any = 1u;
              }
              __stcg(p.alpha + (size_t)rg * p.T + t, a_new);
            }
            a_old = a_new;
            xv[c] = a_new * s.inv[o + c];
          }
        }
        put4(cluster, s.x, row * s.ldx + s.offx + o,
             make_float4(xv[0], xv[1], xv[2], xv[3]), CS, rank, resident);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) em_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  cg::grid_group grid = cg::this_grid();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int tid = threadIdx.x, lane = tid % 32;
  const bool resident = p.KC == 0;
  const Smem s = carve(smem_raw, p, CS, rank);

  pack_bits(p, s, CS, rank);
  for (int i = tid; i < p.ST; i += THREADS) {
    const int t = rank * p.ST + i;
    s.inv[i] = t < p.T ? __ldg(p.inv_eff + t) : 0.f;
  }
  const size_t RT = (size_t)p.R * p.T;
  for (size_t i = (size_t)blockIdx.x * THREADS + tid; i < RT;
       i += (size_t)gridDim.x * THREADS) {
    __stcg(p.alpha + i, __ldg(p.alpha0 + i));
  }
  grid.sync();

  int it = 0, blk = 0;
  while (it < p.max_iters) {
    unsigned max_rel = 0u, any = 0u;
    for (int g = cid; g < p.groups; g += ncl) {
      // the group's n, alpha and x of this block's ECs and transcripts
      for (int i = tid; i < ROWS * p.SE; i += THREADS) {
        const int row = i / p.SE, e = rank * p.SE + i % p.SE;
        const int rg = g * ROWS + row;
        s.n[i] = (e < p.E && rg < p.R) ? __ldg(p.n + (size_t)rg * p.E + e)
                                       : 0.f;
      }
      for (int i = tid; i < ROWS * p.ST / 4; i += THREADS) {
        const int row = i / (p.ST / 4), o = 4 * (i % (p.ST / 4));
        const int rg = g * ROWS + row;
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = rank * p.ST + o + c;
          const float a = (t < p.T && rg < p.R)
                              ? __ldcg(p.alpha + (size_t)rg * p.T + t)
                              : 0.f;
          s.alpha[row * p.ST + o + c] = a;
          xv[c] = a * s.inv[o + c];
        }
        put4(cluster, s.x, row * s.ldx + s.offx + o,
             make_float4(xv[0], xv[1], xv[2], xv[3]), CS, rank, resident);
      }
      cluster.sync();
      for (int step = 0; step < p.C; ++step) {
        run_phase<1>(p, cluster, s, CS, rank, g, step, max_rel, any);
        cluster.sync();
        run_phase<2>(p, cluster, s, CS, rank, g, step, max_rel, any);
        cluster.sync();
      }
    }
    max_rel = __reduce_max_sync(FULL, max_rel);
    any = __reduce_or_sync(FULL, any);
    unsigned int* set = p.sync + 2 * (blk % 3);
    if (lane == 0 && any) {
      atomicMax(set, max_rel);
      atomicOr(set + 1, 1u);
    }
    if (blockIdx.x == 0 && tid < 2) p.sync[2 * ((blk + 1) % 3) + tid] = 0u;
    grid.sync();
    it += p.C;
    const volatile unsigned int* vs = set;
    const bool converged = vs[1] != 0u && __uint_as_float(vs[0]) < p.rel_tol &&
                           it >= p.min_iters;
    ++blk;
    if (converged) break;
  }
  if (blockIdx.x == 0 && tid == 0) p.iters[0] = it;
}

struct Plan {
  int CS, clusters, SE, ST, KC;
  size_t smem;
};

// Pick the cluster size (16, 8, 4, 2 or 1 blocks) and the shared-memory
// layout for a system: resident when x and r fit whole, else depth chunks
// as wide as the room left. Among the sizes that fit, the one with the
// least estimated cycles per block of iterations.
int make_plan(int device, int64_t E, int64_t T, int64_t R, Plan* out) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(em_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(em_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int64_t groups = (R + ROWS - 1) / ROWS;
  double best = -1.0;
  for (int CS : {16, 8, 4, 2, 1}) {
    const int SE = (int)((E + 8 * CS - 1) / (8 * CS) * 8);
    const int ST = (int)((T + 8 * CS - 1) / (8 * CS) * 8);
    int KC = 0;
    if (smem_bytes(CS, SE, ST, 0) > (size_t)max_smem) {
      const int64_t room = ((int64_t)max_smem -
                            (int64_t)smem_bytes(CS, SE, ST, 8)) / 64;
      KC = (int)std::min<int64_t>(CS * std::max(SE, ST), 8 + room / 8 * 8);
      if (room < 0) continue;
    }
    Plan pl{CS, 0, SE, ST, KC, smem_bytes(CS, SE, ST, KC)};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(CS * groups));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int ncl = 0;
    if (cudaOccupancyMaxActiveClusters(&ncl, em_kernel, &cfg) != cudaSuccess ||
        ncl < 1) {
      cudaGetLastError();  // this cluster size does not fit; try the next
      continue;
    }
    pl.clusters = (int)std::min<int64_t>(ncl, groups);
    // cycles a block of iterations costs, roughly: rounds of groups times
    // (mma count of a block + exchanged words / 32 a cycle + syncs)
    const double rounds = (double)((groups + pl.clusters - 1) / pl.clusters);
    const double cost =
        rounds * ((double)CS * SE * ST / 16.0 + 2.0 * CS * (SE + ST) + 3000.0);
    if (best < 0.0 || cost < best) {
      best = cost;
      *out = pl;
    }
  }
  return best < 0.0 ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

// The launch shape K4 takes for a system: {cluster size, clusters, SE, ST,
// KC (0 = resident), shared-memory bytes}.
extern "C" int seekmer_em_plan(void* out, int64_t device, int64_t E, int64_t T,
                               int64_t R) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  const int rc = make_plan((int)device, E, T, R, &pl);
  if (rc != 0) return rc;
  int64_t* o = (int64_t*)out;
  o[0] = pl.CS;
  o[1] = pl.clusters;
  o[2] = pl.SE;
  o[3] = pl.ST;
  o[4] = pl.KC;
  o[5] = (int64_t)pl.smem;
  return 0;
}

extern "C" int seekmer_em_fixed_point(
    const void* M, const void* n, const void* inv_eff, const void* alpha0,
    void* alpha, void* sync, void* iters, void* stream, int64_t device,
    int64_t E, int64_t T, int64_t R, int64_t check_every, int64_t max_iters,
    int64_t min_iters, double rel_tol, double abs_floor, double count_floor) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  const int rc = make_plan((int)device, E, T, R, &pl);
  if (rc != 0) return rc;
  Params p{(const float*)M, (const float*)n, (const float*)inv_eff,
           (const float*)alpha0, (float*)alpha, (unsigned int*)sync,
           (int*)iters, (int)E, (int)T, (int)R,
           (int)std::max<int64_t>(check_every, 1), (int)max_iters,
           (int)min_iters, pl.SE, pl.ST, pl.KC, (int)((R + ROWS - 1) / ROWS),
           (float)rel_tol, (float)abs_floor, (float)count_floor};
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = pl.CS;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pl.CS * pl.clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, em_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
