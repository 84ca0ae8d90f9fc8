// K4: the whole dense EM fixed point in one persistent cooperative launch.
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
// The TPU kernel keeps everything in VMEM and runs the `while` loop in one
// launch. Here the grid is persistent (no larger than the card can hold at
// once, launched with cudaLaunchCooperativeKernel) and every block walks the
// output tiles of each phase:
//
//  * phase 1, denom [R, E] = x [R, T] . M^T, epilogue r = n / denom;
//  * grid.sync();
//  * phase 2, back [R, T] = r [R, E] . M, epilogue alpha' = x * back (written
//    to the output), x = alpha' * inv_eff for the next step, and on the
//    monitored step the convergence terms;
//  * grid.sync().
//
// Convergence is global over all R x T entries, so replicates cannot
// iterate on their own. On a monitored step each warp folds its largest
// relative change (non-negative, so its float bits order as unsigned ints)
// into a slot with atomicMax and its any-active flag with atomicOr. Two
// sets of slots alternate by monitored-step parity: after the closing sync
// every thread reads this step's set, so the exit test is uniform across
// the grid, and block 0 clears the other set for the next monitored step,
// which is at least one grid sync away.
//
// Both products are a shared-memory tiled FP32 FMA loop on the CUDA cores
// (no TF32: JAX asks for Precision.HIGHEST). Each output sums its depth in a
// fixed order and no float atomics touch the products, so two runs give the
// same bits. R = 1 runs the same code: `_em_kernel_r1` existed because the
// TPU's matrix unit wasted 7 of its 8 result rows at R = 1, which is no
// concern here (15 of the 16 tile rows idle instead).
//
// What bounds it on Hopper: shared-memory reads. Per depth step a warp
// issues one A and four B shared-memory reads (five wavefronts) for four
// FMAs a thread, about 2,560 cycles per 64-deep stage on an SM, and each
// tile's depth loop is serial (38 to 54 stages an iteration at config 1),
// so the time scales with stages, not with R. Each stage's global loads
// are issued in one unrolled batch ahead of the previous stage's FMAs, so
// their L2 latency hides. M is read from L2 once per tile row and phase
// (5.6 MB at config 1, resident in the 50 MB L2), and two grid syncs an
// iteration add their latency. Larger register tiles, split depth and
// tensor-core tiles are later work.
//
// Buffers written inside the launch (x, r, alpha and the slots) are read
// with __ldcg or volatile loads, never through L1 or the read-only path.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BR = 16;       // replicate rows per tile
constexpr int BJ = 64;       // output columns per tile
constexpr int BK = 64;       // depth per shared-memory stage
constexpr int TJ = BJ / 16;  // output columns per thread
constexpr int THREADS = 256;  // 16 rows x 16 column groups
constexpr int A_PER = BR * BK / THREADS;  // A-tile loads per thread
constexpr int B_PER = BK * BJ / THREADS;  // B-tile loads per thread

struct Params {
  const float* M;        // [E, T] 0/1 membership
  const float* n;        // [R, E] counts
  const float* inv_eff;  // [T]
  const float* alpha0;   // [R, T]
  float* alpha;          // [R, T] output, the current iterate
  float* x;              // [R, T] scratch, alpha * inv_eff
  float* r;              // [R, E] scratch, n / denom
  unsigned int* slots;   // [4]: max-rel bits and any-active, two sets
  int* iters;            // [1] output
  int E, T, R, C, max_iters, min_iters;
  float rel_tol, abs_floor, count_floor;
};

// One depth stage of a tile into registers: A [BR x BK] and B [BK x BJ],
// zero outside the matrices. Fixed-count unrolled loops, so every load of
// the stage is in flight at once. PHASE 1: A = x, B(k, j) = M[j, k]
// (K = T, J = E); PHASE 2: A = r, B(k, j) = M[k, j] (K = E, J = T).
template <int PHASE>
__device__ __forceinline__ void load_stage(const Params& p, const float* A,
                                           int K, int J, int r0, int j0,
                                           int k0, float ra[A_PER],
                                           float rb[B_PER]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < A_PER; ++m) {
    const int i = tid + m * THREADS;
    const int row = r0 + i / BK, k = k0 + i % BK;
    ra[m] = (row < p.R && k < K) ? __ldcg(A + (size_t)row * K + k) : 0.f;
  }
#pragma unroll
  for (int m = 0; m < B_PER; ++m) {
    const int i = tid + m * THREADS;
    // PHASE 1 reads M rows (output columns) along k, PHASE 2 along j
    const int jj = PHASE == 1 ? i / BK : i % BJ;
    const int kk = PHASE == 1 ? i % BK : i / BJ;
    const int j = j0 + jj, k = k0 + kk;
    float v = 0.f;
    if (j < J && k < K) {
      v = PHASE == 1 ? __ldg(p.M + (size_t)j * p.T + k)
                     : __ldg(p.M + (size_t)k * p.T + j);
    }
    rb[m] = v;
  }
}

// acc[q] = sum_k A[r0 + ty, k] * B(k, j0 + tx + 16 q), k ascending. The
// next stage's loads are issued before the current stage is multiplied.
template <int PHASE>
__device__ __forceinline__ void tile_product(const Params& p, const float* A,
                                             int K, int J, int r0, int j0,
                                             float (*As)[BK + 1],
                                             float (*Bs)[BJ + 1],
                                             float acc[TJ]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float ra[A_PER], rb[B_PER];
#pragma unroll
  for (int q = 0; q < TJ; ++q) acc[q] = 0.f;
  load_stage<PHASE>(p, A, K, J, r0, j0, 0, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int m = 0; m < A_PER; ++m) {
      const int i = tid + m * THREADS;
      As[i / BK][i % BK] = ra[m];
    }
#pragma unroll
    for (int m = 0; m < B_PER; ++m) {
      const int i = tid + m * THREADS;
      if (PHASE == 1) {
        Bs[i % BK][i / BK] = rb[m];
      } else {
        Bs[i / BJ][i % BJ] = rb[m];
      }
    }
    __syncthreads();
    if (k0 + BK < K) load_stage<PHASE>(p, A, K, J, r0, j0, k0 + BK, ra, rb);
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float a = As[ty][kk];
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        acc[q] = fmaf(a, Bs[kk][tx + 16 * q], acc[q]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
em_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float As[BR][BK + 1];
  __shared__ float Bs[BK][BJ + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32;
  const size_t RT = (size_t)p.R * p.T;

  // prologue: alpha = alpha0, x = alpha0 * inv_eff, both slot sets cleared
  for (size_t i = (size_t)blockIdx.x * THREADS + tid; i < RT;
       i += (size_t)gridDim.x * THREADS) {
    const float a = p.alpha0[i];
    p.alpha[i] = a;
    p.x[i] = a * __ldg(p.inv_eff + i % p.T);
  }
  if (blockIdx.x == 0 && tid < 4) p.slots[tid] = 0u;
  grid.sync();

  const int nR = (p.R + BR - 1) / BR;
  const int tiles1 = nR * ((p.E + BJ - 1) / BJ);
  const int tiles2 = nR * ((p.T + BJ - 1) / BJ);
  const int C = p.C;
  int it = 0, parity = 0;
  float acc[TJ];
  while (it < p.max_iters) {
    for (int s = 0; s < C; ++s) {
      const bool monitor = s == C - 1;
      // phase 1: denom = x M^T, r = n / denom
      for (int tile = blockIdx.x; tile < tiles1; tile += gridDim.x) {
        const int r0 = (tile % nR) * BR, j0 = (tile / nR) * BJ;
        tile_product<1>(p, p.x, p.T, p.E, r0, j0, As, Bs, acc);
        const int row = r0 + ty;
#pragma unroll
        for (int q = 0; q < TJ; ++q) {
          const int e = j0 + tx + 16 * q;
          if (row < p.R && e < p.E) {
            const size_t i = (size_t)row * p.E + e;
            const float d = acc[q];
            p.r[i] = d > 0.f ? __ldg(p.n + i) / d : 0.f;
          }
        }
      }
      grid.sync();
      // phase 2: alpha' = x * (r M), x = alpha' * inv_eff
      unsigned int max_rel = 0u, any_active = 0u;
      for (int tile = blockIdx.x; tile < tiles2; tile += gridDim.x) {
        const int r0 = (tile % nR) * BR, j0 = (tile / nR) * BJ;
        tile_product<2>(p, p.r, p.E, p.T, r0, j0, As, Bs, acc);
        const int row = r0 + ty;
#pragma unroll
        for (int q = 0; q < TJ; ++q) {
          const int t = j0 + tx + 16 * q;
          if (row < p.R && t < p.T) {
            const size_t i = (size_t)row * p.T + t;
            const float a_new = __ldcg(p.x + i) * acc[q];
            if (monitor && a_new > p.count_floor) {
              const float rel =
                  fabsf(a_new - __ldcg(p.alpha + i)) / (a_new + p.abs_floor);
              max_rel = max(max_rel, __float_as_uint(rel));
              any_active = 1u;
            }
            p.alpha[i] = a_new;
            p.x[i] = a_new * __ldg(p.inv_eff + t);
          }
        }
      }
      if (monitor) {
        max_rel = __reduce_max_sync(0xffffffffu, max_rel);
        any_active = __reduce_or_sync(0xffffffffu, any_active);
        if (lane == 0 && any_active) {
          atomicMax(p.slots + 2 * parity, max_rel);
          atomicOr(p.slots + 2 * parity + 1, 1u);
        }
        if (blockIdx.x == 0 && tid < 2) p.slots[2 * (parity ^ 1) + tid] = 0u;
      }
      grid.sync();
    }
    it += C;
    const volatile unsigned int* slot = p.slots + 2 * parity;
    const bool converged = slot[1] != 0u &&
                           __uint_as_float(slot[0]) < p.rel_tol &&
                           it >= p.min_iters;
    parity ^= 1;
    if (converged) break;
  }
  if (blockIdx.x == 0 && tid == 0) p.iters[0] = it;
}

}  // namespace

extern "C" int seekmer_em_fixed_point(
    const void* M, const void* n, const void* inv_eff, const void* alpha0,
    void* alpha, void* x, void* r, void* slots, void* iters, void* stream,
    int64_t device, int64_t E, int64_t T, int64_t R, int64_t check_every,
    int64_t max_iters, int64_t min_iters, double rel_tol, double abs_floor,
    double count_floor) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               (int)device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, em_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t nR = (R + BR - 1) / BR;
  int64_t tiles = nR * ((std::max(E, T) + BJ - 1) / BJ);
  tiles = std::max<int64_t>(tiles, 1);
  const unsigned int blocks =
      (unsigned int)std::min<int64_t>(tiles, (int64_t)per_sm * sms);
  Params p{(const float*)M, (const float*)n, (const float*)inv_eff,
           (const float*)alpha0, (float*)alpha, (float*)x, (float*)r,
           (unsigned int*)slots, (int*)iters, (int)E, (int)T, (int)R,
           (int)std::max<int64_t>(check_every, 1), (int)max_iters,
           (int)min_iters, (float)rel_tol, (float)abs_floor,
           (float)count_floor};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)em_kernel, dim3(blocks),
                                    dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
