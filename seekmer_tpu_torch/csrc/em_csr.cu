// A3: the CSR EM fixed point in one launch, each connected component's
// E and M phases in shared memory.
//
// Counterpart of seekmer_tpu/em/em.py `em_step` (single run) and
// seekmer_tpu/em/bootstrap.py `_batched_iter` (the bootstrap's batched
// EM), driven by `run_blocked_fixed_point` / `_block_body` (em.py:163-206),
// which JAX ran as XLA segment sums inside one while_loop (no Pallas
// kernel). For each EC c and replicate b, with w_tb = alpha_tb / eff_t
// (single run) or alpha_tb * inv_eff_t (batched):
//
//   E: d_cb = sum_{t in c} w_tb
//   M: alpha'_tb = sum_{c ni t} (d_cb > 0 ? (n_cb w_tb) / d_cb : 0)
//
// in blocks of C = check_every steps; after each block, the test between
// its last two iterates: converged when some alpha' > count_floor, the
// largest |alpha' - alpha| / (alpha' + abs_floor) over those is below
// rel_tol, and it + C >= min_iters; stop then or at max_iters. The iterate
// is (T, B), replicate-minor; the counts are (E, B).
//
// What bounds it on Hopper, and what the design does about it:
//
//  * The iteration splits exactly over the connected components of the
//    EC-transcript graph, and over the replicates. A transcriptome's
//    components are genes of a few isoforms, a few KB at 32 replicates. So
//    the table is cut into tiles of whole components (tiled_layout in
//    ops/em_csr_cuda.py, torch ops on the card) and the replicates into
//    slices of up to 32, and a block runs a (tile, slice) item's steps in
//    shared memory: its local CSR and CSC, scale, iterate, weights, {n, d}
//    and r. No step needs a grid barrier. Device memory sees alpha and n
//    in and alpha out once a block of steps (streamed: more items than the
//    grid holds at once, as at B = 100) or once a launch (resident: a
//    block an item, as in the single run).
//  * A step is three phases between __syncthreads(), a thread an item of
//    each: E, d of each (EC, replicate) from the members' weights (stored
//    once a step: alpha / eff or alpha * 1/eff, the plain version's w);
//    M1, r = (n w) / d of each (CSC entry, replicate), n and d in one 8- or
//    16-byte load; M2, each (transcript, replicate) sums its run of r and
//    stores the new iterate and its weight. Splitting M keeps quotients
//    out of the sums' chains: in the single run a transcript with 29 ECs
//    otherwise divides its way down its run alone.
//  * As measured (PERF.md), the quotients bound it: the M phases take
//    twice the time they take with a product in place of the quotient;
//    nvcc's __fdiv_rn sends zero numerators to its slow path, so 0 / d is
//    taken as +0 without one. Rows are stored longest first in each tile,
//    so the rows a block's threads take in turn are of even length.
//  * The iterate is kept in place: the last step keeps the old value for
//    the test and writes the new one (and, for em_steps, the old) out.
//  * The test is on the card, as JAX's while_loop is: each thread folds
//    its entries' relative change into a 64-bit key (a non-negative
//    float's bits order as the float; a NaN takes the largest key, so it
//    leaves the run unconverged as torch.max's NaN does), warps reduce by
//    shuffles, lanes 0 atomicMax into one of three rotating slot sets,
//    then one grid barrier a block of steps; every block reads the same
//    set and takes the same decision (the scheme of K4, csrc/em.cu).
//    rel_tol, abs_floor and count_floor come rounded to the iterate's
//    type, and the expression rounds as torch's does on the CPU.
//  * Components too large for a tile (a real transcriptome may have a
//    giant one) take the global route inside the same launch: the same
//    phases over their rows in device memory (M fused), every block a
//    share, two grid barriers a step, d in an (E_global, B) scratch.
//  * Order of operations: each (EC, replicate) sums w over the EC's
//    members in CSR order, each (transcript, replicate) sums r over its
//    CSC run in nnz order: the orders in which the CPU's index_add_ adds.
//    Products, quotients and sums use the _rn intrinsics, which nvcc never
//    contracts into an fma. So the kernel gives the plain version's bits
//    on the CPU, and the same bits every run: the tiles move where a row
//    is stored, never the order of a sum.
//  * Values written inside the launch and read by another block (the
//    iterate between blocks of steps, the global route's d) go through L2
//    (__stcg / __ldcg), never a stale L1 line.
//  * 2 blocks of 512 threads an SM (64 registers a thread), each with half
//    the SM's shared memory: as measured, 1 block of 512 or 1024, 2 of
//    256 and 4 of 256 are no faster.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;

constexpr int BLOCKS_PER_SM = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NAN_KEY = ~0ull;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float mag(float a) { return fabsf(a); }
__device__ __forceinline__ unsigned long long key_of(float x) {
  return isnan(x) ? NAN_KEY : (unsigned long long)__float_as_uint(x);
}
__device__ __forceinline__ bool below(unsigned long long k, float tol) {
  return k != NAN_KEY && __uint_as_float((unsigned)k) < tol;
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double mag(double a) { return fabs(a); }
__device__ __forceinline__ unsigned long long key_of(double x) {
  return isnan(x) ? NAN_KEY : (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ bool below(unsigned long long k, double tol) {
  return k != NAN_KEY && __longlong_as_double((long long)k) < tol;
}

template <typename F>
struct Params {
  const F* alpha0;         // (T, B) the iterate the launch starts from
  F* out;                  // (T, B) the last iterate
  F* prev;                 // (T, B) the one before it, or null
  const F* n;              // (E, B) counts
  const F* scale;          // (T,) eff (divide) or 1 / eff
  F* dg;                   // (E_global, B) the global route's d
  const int32_t* tile_t0;  // (ntiles + 2) first local transcript of a tile
  const int32_t* tile_e0;  // (ntiles + 2) first local EC
  const int32_t* tile_z0;  // (ntiles + 2) first entry
  const int32_t* rows_t;   // (T) global id of each local transcript
  const int32_t* rows_e;   // (E) global id of each local EC
  const int32_t* ec_off;   // (E + ntiles + 1) local CSR offsets, by tile
  const int32_t* txp;      // (nnz) members, local (global in the global set)
  const int32_t* txp_off;  // (T + ntiles + 1) local CSC offsets, by tile
  const int32_t* csc;      // (nnz) local EC of each CSC entry
  unsigned long long* state;  // 3 slot sets {max key, any}, then it, conv
  int ntiles, B, S, slices, C;
  long long max_iters, min_iters, it_init;
  bool resident, test, divide;
  F rel_tol, abs_floor, count_floor;
};

// A tile's rows: its local CSR and CSC (in shared memory once loaded)
// and the global ids of its rows.
struct Tile {
  const int32_t* ec_off;
  const int32_t* txp;
  const int32_t* txp_off;
  const int32_t* csc;
  const int32_t* rows_t;
  const int32_t* rows_e;
  int E, T, Z;
};

// n and d of an (EC, replicate), side by side for one load.
template <typename F>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// A (tile, slice) item held in shared memory: width w, replicates from b0.
template <typename F>
struct Held {
  Tile g;
  const int32_t* crow;          // (Z) local transcript of each CSC entry
  F* scale;                     // (T) eff or 1 / eff
  F* alpha;                     // (T, w) the iterate
  F* wt;                        // (T, w) its weights, alpha / eff or * 1/eff
  typename Pair<F>::type* nd;   // (E, w) {n, d}
  F* rr;                        // (Z, w) r of each CSC entry
  int w, b0;
};

struct Fold {
  unsigned long long key = 0;
  bool any = false;
};

template <typename F>
__device__ __forceinline__ F weight(F x, F s, bool divide) {
  return divide ? quo(x, s) : mul(x, s);
}

template <typename F>
__device__ Tile tile_at(const Params<F>& p, int i) {
  const int t0 = p.tile_t0[i], e0 = p.tile_e0[i], z0 = p.tile_z0[i];
  return Tile{p.ec_off + e0 + i,  p.txp + z0,         p.txp_off + t0 + i,
              p.csc + z0,         p.rows_t + t0,      p.rows_e + e0,
              p.tile_e0[i + 1] - e0, p.tile_t0[i + 1] - t0,
              p.tile_z0[i + 1] - z0};
}

// Calls fn(i, row, lane) for the items i = row * w + lane < rows * w from
// `first` in strides of `stride`, without a division per item.
template <typename Fn>
__device__ __forceinline__ void for_items(int rows, int w, int first,
                                          int stride, Fn fn) {
  int r = first / w, b = first - r * w;
  const int dr = stride / w, db = stride - dr * w;
  for (int i = first; r < rows; i += stride) {
    fn(i, r, b);
    r += dr;
    b += db;
    if (b >= w) {
      b -= w;
      ++r;
    }
  }
}

// The last step's end of an M-phase item: the new iterate (and the old,
// for em_steps) to memory, the relative change into the test's fold.
template <typename F>
__device__ __forceinline__ void finish(const Params<F>& p, size_t o, F old,
                                       F now, Fold& f) {
  __stcg(p.out + o, now);
  if (p.prev) __stcg(p.prev + o, old);
  if (p.test && now > p.count_floor) {
    f.any = true;
    f.key = max(f.key, key_of(quo(mag(sub(now, old)), add(now, p.abs_floor))));
  }
}

// A block of C steps on an item in shared memory, a thread an item of each
// phase: the E-phase sums each (EC, replicate)'s member weights, two loads
// a member; M1 computes each (CSC entry, replicate)'s r, reading n and d
// in one 8- or 16-byte load; M2 sums each (transcript, replicate)'s run
// and writes the new iterate and its weight.
template <typename F>
__device__ void held_steps(const Params<F>& p, const Held<F>& h, Fold& f) {
  using F2 = typename Pair<F>::type;
  const Tile& g = h.g;
  const int w = h.w, tid = threadIdx.x;
  for (int s = 0; s < p.C; ++s) {
    for_items(g.E, w, tid, THREADS, [&](int i, int r, int b) {
      F acc = F(0);
      const int end = g.ec_off[r + 1];
      for (int j = g.ec_off[r]; j < end; ++j) {
        acc = add(acc, h.wt[g.txp[j] * w + b]);
      }
      h.nd[i].y = acc;
    });
    __syncthreads();
    // M1: r of every (CSC entry, replicate) at once, so that no quotient
    // waits on a sum. 0 / d is +0 without a division (nvcc's takes its slow
    // path on a zero numerator, and one lane takes its whole warp there)
    for_items(g.Z, w, tid, THREADS, [&](int i, int k, int b) {
      const F2 nd = h.nd[g.csc[k] * w + b];
      const F nx = mul(nd.x, h.wt[h.crow[k] * w + b]);
      h.rr[i] = nd.y > F(0) && nx != F(0) ? quo(nx, nd.y) : F(0);
    });
    __syncthreads();
    // M2: each (transcript, replicate) sums its run in CSC order
    const bool last = s + 1 == p.C;
    for_items(g.T, w, tid, THREADS, [&](int i, int r, int b) {
      F acc = F(0);
      const int end = g.txp_off[r + 1];
      for (int k = g.txp_off[r]; k < end; ++k) acc = add(acc, h.rr[k * w + b]);
      if (last) {
        finish(p, (size_t)g.rows_t[r] * p.B + h.b0 + b, h.alpha[i], acc, f);
      }
      h.alpha[i] = acc;
      h.wt[i] = weight(acc, h.scale[r], p.divide);
    });
    __syncthreads();
  }
}

// Copy item `item` (tile item / slices, slice item % slices) into shared
// memory, its iterate from `src`. Carved as item_bytes in
// ops/em_csr_cuda.py counts it.
template <typename F>
__device__ Held<F> load(const Params<F>& p, int item, unsigned char* smem,
                        const F* src) {
  const int i = item / p.slices, j = item - i * p.slices;
  const Tile g = tile_at(p, i);
  const int tid = threadIdx.x;
  Held<F> h;
  h.b0 = j * p.S;
  h.w = min(p.S, p.B - h.b0);
  int32_t* ec_off = reinterpret_cast<int32_t*>(smem);
  int32_t* txp = ec_off + g.E + 1;
  int32_t* txp_off = txp + g.Z;
  int32_t* csc = txp_off + g.T + 1;
  int32_t* crow = csc + g.Z;
  const int idx = g.E + g.T + 2 + 3 * g.Z;
  // {n, d} first: 16-byte aligned for double2
  h.nd = reinterpret_cast<typename Pair<F>::type*>(smem +
                                                   (4 * idx + 15) / 16 * 16);
  h.scale = reinterpret_cast<F*>(h.nd + g.E * h.w);
  h.alpha = h.scale + g.T;
  h.wt = h.alpha + g.T * h.w;
  h.rr = h.wt + g.T * h.w;
  h.crow = crow;
  for (int k = tid; k <= g.E; k += THREADS) ec_off[k] = g.ec_off[k];
  for (int k = tid; k <= g.T; k += THREADS) txp_off[k] = g.txp_off[k];
  for (int k = tid; k < g.Z; k += THREADS) {
    txp[k] = g.txp[k];
    csc[k] = g.csc[k];
  }
  for (int k = tid; k < g.T; k += THREADS) {
    h.scale[k] = __ldg(p.scale + g.rows_t[k]);
    const int end = g.txp_off[k + 1];
    for (int z = g.txp_off[k]; z < end; ++z) crow[z] = k;
  }
  const int w = h.w;
  for_items(g.E, w, tid, THREADS, [&](int k, int r, int b) {
    h.nd[k].x = __ldg(p.n + (size_t)g.rows_e[r] * p.B + h.b0 + b);
  });
  __syncthreads();  // the scale
  for_items(g.T, w, tid, THREADS, [&](int k, int r, int b) {
    const F a = __ldcg(src + (size_t)g.rows_t[r] * p.B + h.b0 + b);
    h.alpha[k] = a;
    h.wt[k] = weight(a, h.scale[r], p.divide);
  });
  h.g = Tile{ec_off, txp, txp_off, csc, g.rows_t, g.rows_e, g.E, g.T, g.Z};
  __syncthreads();
  return h;
}

// A block of C steps over the global set, every block a share of its
// (row, replicate) items; the iterate in `out`, d in `dg`.
template <typename F>
__device__ void global_steps(const Params<F>& p, cg::grid_group& grid,
                             bool from_alpha0, Fold& f) {
  const Tile g = tile_at(p, p.ntiles);
  const int first = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  for (int s = 0; s < p.C; ++s) {
    const F* src = (from_alpha0 && s == 0) ? p.alpha0 : p.out;
    for_items(g.E, p.B, first, stride, [&](int i, int r, int b) {
      F acc = F(0);
      const int end = g.ec_off[r + 1];
      for (int j = g.ec_off[r]; j < end; ++j) {
        const int t = g.txp[j];
        acc = add(acc, weight(__ldcg(src + (size_t)t * p.B + b),
                              __ldg(p.scale + t), p.divide));
      }
      __stcg(p.dg + i, acc);
    });
    grid.sync();
    const bool last = s + 1 == p.C;
    for_items(g.T, p.B, first, stride, [&](int i, int r, int b) {
      const int t = g.rows_t[r];
      const size_t o = (size_t)t * p.B + b;
      const F a = __ldcg(src + o);
      const F x = weight(a, __ldg(p.scale + t), p.divide);
      F acc = F(0);
      const int end = g.txp_off[r + 1];
      for (int k = g.txp_off[r]; k < end; ++k) {
        const int c = g.csc[k];
        const F dd = __ldcg(p.dg + (size_t)c * p.B + b);
        const F nx = mul(__ldg(p.n + (size_t)g.rows_e[c] * p.B + b), x);
        acc = add(acc, dd > F(0) && nx != F(0) ? quo(nx, dd) : F(0));
      }
      if (last) {
        finish(p, o, a, acc, f);
      } else {
        __stcg(p.out + o, acc);
      }
    });
    if (!last) grid.sync();
  }
}

template <typename F>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    em_csr_kernel(Params<F> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int items = p.ntiles * p.slices;
  const bool has_global = p.tile_t0[p.ntiles + 1] > p.tile_t0[p.ntiles];
  const bool holds = p.resident && (int)blockIdx.x < items;
  Held<F> held;
  if (holds) held = load(p, blockIdx.x, smem, p.alpha0);
  long long it = p.it_init;
  bool converged = false;
  for (int blk = 0; it < p.max_iters; ++blk) {
    Fold f;
    if (holds) {
      held_steps(p, held, f);
    } else if (!p.resident) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Held<F> h = load(p, item, smem, blk == 0 ? p.alpha0 : p.out);
        held_steps(p, h, f);
      }
    }
    if (has_global) global_steps(p, grid, blk == 0, f);
    it += p.C;
    if (!p.test) break;
    unsigned long long key = f.key;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      key = max(key, __shfl_xor_sync(FULL, key, o));
    }
    const bool any = __any_sync(FULL, f.any);
    unsigned long long* set = p.state + 2 * (blk % 3);
    if (threadIdx.x % 32 == 0 && any) {
      atomicMax(set, key);
      atomicOr(set + 1, 1ull);
    }
    // the set the next block of steps takes was last read before the
    // barrier of the block before this one, which every block has passed
    if (blockIdx.x == 0 && threadIdx.x < 2) {
      p.state[2 * ((blk + 1) % 3) + threadIdx.x] = 0ull;
    }
    grid.sync();
    const volatile unsigned long long* vs = set;
    converged = vs[1] != 0ull && below(vs[0], p.rel_tol) && it >= p.min_iters;
    if (converged) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.state[6] = (unsigned long long)it;
    p.state[7] = converged ? 1ull : 0ull;
  }
}

// Blocks the card holds at once and the shared memory each may take:
// BLOCKS_PER_SM blocks an SM, each with its share of the SM's shared
// memory.
template <typename F>
int shape_of(int device, int64_t* out) {
  int sms = 0, per_sm = 0, optin = 0, reserved = 0, fit = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  }
  if (err != cudaSuccess) return (int)err;
  const int cap = std::min(optin, per_sm / BLOCKS_PER_SM - reserved) / 16 * 16;
  err = cudaFuncSetAttribute(em_csr_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, em_csr_kernel<F>,
                                                      THREADS, cap);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  out[0] = (int64_t)sms * fit;
  out[1] = cap;
  return 0;
}

template <typename F>
int launch(Params<F> p, int grid, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      em_csr_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)em_csr_kernel<F>, grid,
                                    THREADS, args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename F>
Params<F> params(const void* alpha0, void* out, void* prev, const void* n,
                 const void* scale, void* dg, const int32_t* const* idx,
                 void* state, int64_t ntiles, int64_t B, int64_t S,
                 int64_t slices, int64_t resident, int64_t C,
                 int64_t max_iters, int64_t min_iters, int64_t it_init,
                 int64_t test, int64_t divide, double rel_tol,
                 double abs_floor, double count_floor) {
  return Params<F>{(const F*)alpha0,
                   (F*)out,
                   (F*)prev,
                   (const F*)n,
                   (const F*)scale,
                   (F*)dg,
                   idx[0], idx[1], idx[2], idx[3], idx[4], idx[5], idx[6],
                   idx[7], idx[8],
                   (unsigned long long*)state,
                   (int)ntiles, (int)B, (int)S, (int)slices, (int)C,
                   max_iters, min_iters, it_init,
                   resident != 0, test != 0, divide != 0,
                   (F)rel_tol, (F)abs_floor, (F)count_floor};
}

// A4: each EC's sum of its members' terms w in CSR order from 0, d_c =
// ((0 + w_z0) + w_z0+1) + ..., the order of the CPU's index_add_ and of
// the E-phase above, so the card gives the CPU's bits (log_likelihood's
// denominators; seekmer_tpu/em/em.py:441 summed them by XLA's
// segment_sum). A thread an EC: only the adds chain, the loads of a row
// are independent and unrolled ahead of them.
template <typename F>
__global__ void ec_sum_kernel(const F* __restrict__ w,
                              const int32_t* __restrict__ ec_off,
                              F* __restrict__ out, int E) {
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < E; c += stride) {
    const int end = ec_off[c + 1];
    F d = 0;
#pragma unroll 8
    for (int z = ec_off[c]; z < end; ++z) d = add(d, __ldg(w + z));
    out[c] = d;
  }
}

template <typename F>
int ec_sum(const void* w, const void* ec_off, void* out, int E,
           cudaStream_t st) {
  constexpr int kThreads = 256;
  ec_sum_kernel<F><<<seekmer::grid_for(E, kThreads), kThreads, 0, st>>>(
      (const F*)w, (const int32_t*)ec_off, (F*)out, E);
  return (int)cudaGetLastError();
}

}  // namespace

// A4: out[c] = the sum of w[ec_off[c]:ec_off[c + 1]] in order from 0, for
// the E ECs of a CSR (ec_off int32, E + 1 entries); float64 when dbl.
extern "C" int seekmer_ec_sum(const void* w, const void* ec_off, void* out,
                              void* stream, int64_t device, int64_t E,
                              int64_t dbl) {
  if (E < 0 || E >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  if (E == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return dbl ? ec_sum<double>(w, ec_off, out, (int)E, st)
             : ec_sum<float>(w, ec_off, out, (int)E, st);
}

// {blocks the card holds at once, shared-memory bytes each may take}.
extern "C" int seekmer_em_csr_shape(void* out, int64_t device, int64_t dbl) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  return dbl ? shape_of<double>((int)device, (int64_t*)out)
             : shape_of<float>((int)device, (int64_t*)out);
}

// The fixed point (test != 0) or `C` steps with the test off, from
// alpha0 into out (and prev, if not null), over the tiled layout of
// tiled_layout in ops/em_csr_cuda.py. state: 8 zeroed int64, of which [6]
// gets the iteration count and [7] whether it converged. The tolerances
// are rounded to the iterate's type here.
extern "C" int seekmer_em_csr(
    const void* alpha0, void* out, void* prev, const void* n,
    const void* scale, void* dg, const void* tile_t0, const void* tile_e0,
    const void* tile_z0, const void* rows_t, const void* rows_e,
    const void* ec_off, const void* txp, const void* txp_off,
    const void* csc, void* state, void* stream, int64_t device,
    int64_t ntiles, int64_t B, int64_t S, int64_t slices, int64_t smem,
    int64_t grid, int64_t resident, int64_t C, int64_t max_iters,
    int64_t min_iters, int64_t it_init, int64_t test, int64_t divide,
    int64_t dbl, double rel_tol, double abs_floor, double count_floor) {
  if (ntiles < 0 || B <= 0 || S <= 0 || slices <= 0 || C <= 0 || grid <= 0 ||
      smem < 0 || S * slices < B) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  const int32_t* idx[] = {
      (const int32_t*)tile_t0, (const int32_t*)tile_e0,
      (const int32_t*)tile_z0, (const int32_t*)rows_t,
      (const int32_t*)rows_e,  (const int32_t*)ec_off,
      (const int32_t*)txp,     (const int32_t*)txp_off,
      (const int32_t*)csc};
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) {
    return launch(params<double>(alpha0, out, prev, n, scale, dg, idx, state,
                                 ntiles, B, S, slices, resident, C, max_iters,
                                 min_iters, it_init, test, divide, rel_tol,
                                 abs_floor, count_floor),
                  (int)grid, (int)smem, st);
  }
  return launch(params<float>(alpha0, out, prev, n, scale, dg, idx, state,
                              ntiles, B, S, slices, resident, C, max_iters,
                              min_iters, it_init, test, divide, rel_tol,
                              abs_floor, count_floor),
                (int)grid, (int)smem, st);
}
