// A3: the CSR EM iteration, a block of steps in one cooperative launch.
//
// Counterpart of seekmer_tpu/em/em.py `em_step` (single run) and
// seekmer_tpu/em/bootstrap.py `_batched_iter` (the bootstrap's batched
// EM), which JAX ran as XLA segment sums (no Pallas kernel). For each EC c
// and replicate b, with w_tb = alpha_tb / eff_t (single run) or
// alpha_tb * inv_eff_t (batched):
//
//   E: d_cb = sum_{t in c} w_tb
//   M: alpha'_tb = sum_{c ni t} (d_cb > 0 ? (n_cb w_tb) / d_cb : 0)
//
// The iterate is (T, B), replicate-minor; the counts are (E, B).
//
// What bounds it on Hopper: bytes. An iteration has to read alpha and the
// counts and write alpha' (81 MB at 57,273 transcripts, 83,019 ECs and 100
// replicates; ~24 us at 3.35 TB/s); its operations are ~5 a membership
// entry and replicate. At B = 1 the bytes are ~1 us and the latency of
// each phase's longest chain of loads, and the grid barriers, set the
// time. The design:
//
//  * One launch runs `steps` iterations (the blocked schedule's
//    check_every), grid-stride loops over a grid the card holds at once,
//    two grid barriers a step (none after the last), ping-pong iterates.
//    It returns the last two iterates for the host's convergence test.
//  * A thread owns one (row, replicate) item: neighbouring threads take
//    neighbouring replicates of one row, so a row's B values are read as
//    one coalesced span; at B = 1 a thread owns a whole row, so no lane
//    idles on the narrow EC rows (two members on average).
//  * E-phase: a thread sums w over its EC's members in CSR order into the
//    (E, B) scratch d. M-phase: a thread walks its transcript's CSC run
//    (the nnz of that transcript in nnz order) and sums r in that order.
//    Those are the orders in which the CPU's index_add_ adds, and every
//    operation rounds as the plain version's does: (n w) / d, products and
//    sums with the _rn intrinsics, which nvcc never contracts into an fma.
//    So the kernel gives the plain version's bits on the CPU, and the same
//    bits every run: no atomics.
//  * Below 32 replicates (the single run), a thread loads up to CHUNK
//    members' indices, then their values, then adds them in order, so a
//    row costs a few round trips to memory, not two per member: at B = 1
//    the longest row and the longest CSC run (10 and 18 entries at config
//    2) would otherwise set each phase's time. The chunk costs registers
//    (80 for float, 32 without), and so occupancy, which the bootstrap's
//    wide iterates, bound by the bytes in flight across the card, cannot
//    spare: there a thread takes one member at a time.
//  * Values written inside the launch (the iterates, d) are read with
//    __ldcg, from L2: another SM may have written them since this SM's L1
//    last saw the line.

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8;  // loads in flight a thread, below 32 replicates

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename F>
struct CsrArgs {
  const F* alpha0;         // (T, B) the iterate the launch starts from
  const F* n;              // (E, B) counts
  const F* scale;          // (T,) eff (divide) or 1 / eff
  const int32_t* ec_off;   // (E + 1) CSR row offsets
  const int32_t* txp;      // (nnz) member transcripts, CSR order
  const int32_t* txp_off;  // (T + 1) CSC run offsets
  const int32_t* csc_ec;   // (nnz) EC of each CSC entry
  F* d;                    // (E, B) scratch
  F* out0;                 // (T, B) iterate of even steps
  F* out1;                 // (T, B) iterate of odd steps
  uint32_t E, T, B;
  int steps;
  bool divide;
};

template <typename F>
__device__ __forceinline__ F weight(F x, F s, bool divide) {
  return divide ? quo(x, s) : mul(x, s);
}

template <typename F, int K>
__global__ void __launch_bounds__(THREADS) em_csr_kernel(CsrArgs<F> a) {
  cg::grid_group grid = cg::this_grid();
  const uint32_t stride = gridDim.x * THREADS;
  const uint32_t first = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t EB = a.E * a.B, TB = a.T * a.B;  // < 2^31 (the wrapper)
  const F* src = a.alpha0;
  for (int s = 0; s < a.steps; ++s) {
    F* dst = (s & 1) ? a.out1 : a.out0;
    for (uint32_t i = first; i < EB; i += stride) {
      const uint32_t c = i / a.B, b = i - c * a.B;
      const int32_t beg = __ldg(a.ec_off + c);
      const int32_t end = __ldg(a.ec_off + c + 1);
      F acc = F(0);
      for (int32_t j = beg; j < end; j += K) {
        const int cnt = min(K, end - j);
        uint32_t t[K];
        F x[K], sc[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) t[q] = (uint32_t)__ldg(a.txp + j + q);
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) {
            x[q] = __ldcg(src + (size_t)t[q] * a.B + b);
            sc[q] = __ldg(a.scale + t[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) acc = add(acc, weight(x[q], sc[q], a.divide));
        }
      }
      a.d[i] = acc;
    }
    grid.sync();
    for (uint32_t i = first; i < TB; i += stride) {
      const uint32_t t = i / a.B, b = i - t * a.B;
      const int32_t beg = __ldg(a.txp_off + t);
      const int32_t end = __ldg(a.txp_off + t + 1);
      const F w = weight(__ldcg(src + i), __ldg(a.scale + t), a.divide);
      F acc = F(0);
      for (int32_t k = beg; k < end; k += K) {
        const int cnt = min(K, end - k);
        uint32_t cb[K];
        F dd[K], nn[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) cb[q] = (uint32_t)__ldg(a.csc_ec + k + q) * a.B + b;
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) {
            dd[q] = __ldcg(a.d + cb[q]);
            nn[q] = __ldg(a.n + cb[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q < cnt) {
            acc = add(acc, dd[q] > F(0) ? quo(mul(nn[q], w), dd[q]) : F(0));
          }
        }
      }
      dst[i] = acc;
    }
    if (s + 1 < a.steps) grid.sync();
    src = dst;
  }
}

// Blocks of one form of the kernel the card holds at once (cached by
// device: the query costs host time every call).
template <typename F, int K>
int cooperative_blocks(int device) {
  static std::mutex mu;
  static int cached_device = -1;
  static int cached_blocks = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, em_csr_kernel<F, K>, THREADS, 0);
    cached_device = device;
    cached_blocks = sms * per_sm;
  }
  return cached_blocks;
}

template <typename F, int K>
int launch_as(CsrArgs<F> a, int device, cudaStream_t st) {
  const int64_t work = (int64_t)std::max(a.E, a.T) * a.B;
  const int cap = cooperative_blocks<F, K>(device);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned grid = (unsigned)std::min<int64_t>(
      std::max<int64_t>(seekmer::grid_for(work, THREADS), 1), cap);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)em_csr_kernel<F, K>,
                                          grid, THREADS, args, 0, st);
}

// Loads chunked below 32 replicates, one member at a time above.
template <typename F>
int launch(CsrArgs<F> a, int device, cudaStream_t st) {
  return a.B < 32 ? launch_as<F, CHUNK>(a, device, st)
                  : launch_as<F, 1>(a, device, st);
}

}  // namespace

extern "C" int seekmer_em_csr(const void* alpha, const void* n,
                              const void* scale, const void* ec_off,
                              const void* txp, const void* txp_off,
                              const void* csc_ec, void* d, void* out0,
                              void* out1, void* stream, int64_t device,
                              int64_t E, int64_t T, int64_t B, int64_t steps,
                              int64_t divide, int64_t dbl) {
  if (E < 0 || T <= 0 || B <= 0 || steps <= 0 ||
      std::max(E, T) * B >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaSetDevice((int)device);
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) {
    CsrArgs<double> a{(const double*)alpha, (const double*)n,
                      (const double*)scale, (const int32_t*)ec_off,
                      (const int32_t*)txp, (const int32_t*)txp_off,
                      (const int32_t*)csc_ec, (double*)d, (double*)out0,
                      (double*)out1, (uint32_t)E, (uint32_t)T, (uint32_t)B,
                      (int)steps, divide != 0};
    return launch(a, (int)device, st);
  }
  CsrArgs<float> a{(const float*)alpha, (const float*)n, (const float*)scale,
                   (const int32_t*)ec_off, (const int32_t*)txp,
                   (const int32_t*)txp_off, (const int32_t*)csc_ec, (float*)d,
                   (float*)out0, (float*)out1, (uint32_t)E, (uint32_t)T,
                   (uint32_t)B, (int)steps, divide != 0};
  return launch(a, (int)device, st);
}
