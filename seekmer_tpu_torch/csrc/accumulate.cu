// A1: fold one batch of read signatures into the signature count table.
//
// Counterpart of seekmer_tpu/map/signature.py `accumulate` and
// `accumulate_direct`, which the JAX package ran in XLA (no Pallas kernel):
// a scatter-then-regather compare-and-swap inside a while_loop, one probe
// round per loop iteration, with the count scatter-add, the winners' row
// scatter and the collision audit after the loop. In eager PyTorch that
// loop would sync with the host every round, and a duplicate-index write
// of the two int32 fingerprint halves can tear on the GPU (each half from
// a different lane, so the slot holds a key nobody owns).
//
// What bounds it on Hopper: not bytes (~0.7 MB for a config-2 batch on an
// empty table, 0.0022 ms at 3.35 TB/s) but chains of dependent memory
// latency (row, fingerprint, key bucket, CAS, count) with 65,536 reads a
// batch, and the fixed cost of a launch. The design shortens each chain:
//
//  * A warp owns 32 consecutive reads. It copies their rows (2 KB at C =
//    16) into shared memory with 16-byte loads, so every row is read from
//    device memory once, coalesced; each lane then folds its own row's
//    64-bit fingerprint (the sig_fingerprint of map/signature.py).
//  * Single-EC rows (sig[1] == SIG_PAD) go to the exact per-EC vector with
//    one atomicAdd (the `accumulate_direct` path), when the table has one.
//  * A multi-EC lane reads its whole 64-byte key bucket as four 16-byte
//    loads in flight at once (from L2: other lanes claim slots during the
//    launch), finds its fingerprint or the empty slots in registers, and
//    atomicCASes the first empty one; a CAS that returns its own
//    fingerprint is a match, one that returns another key moves on to the
//    next slot that was empty in the view. The key table is read as uint64
//    (a view of the same int32[..., KB, 2] storage), so a claim can never
//    tear. Slots fill left to right, as in the slot-by-slot walk: a lane
//    claims slot j only when every slot before it holds another key.
//  * The winner of a claim writes the row with 16-byte stores; every
//    resolved lane atomicAdds its weight into count; a lane that exhausts
//    `sig_probe` buckets adds its weight to `overflow`.
//  * Audit: a winner wrote its slot's row itself, and no other lane ever
//    writes that row, so only the lanes that matched an existing key can
//    find a mismatch. With the audit on, the launch is cooperative: after
//    one grid barrier (every winner's row written and visible) each
//    matcher compares its row, still in shared memory, with its slot's
//    stored row and adds its weight to `collisions` on a mismatch. Without
//    the barrier a matcher could read the row before its winner wrote it.
//    Batches larger than the card holds at once go round in passes, one
//    barrier a pass.
//
// Budget: JAX spends one of its `sig_probe` rounds per bucket visited and
// per lost claim retried; here only buckets count (a lost CAS moves on to
// the next slot of the same bucket at no cost). The overflow counts agree
// whenever no lane exhausts its budget. Slot placement under concurrent
// claims differs from JAX, so results are compared after the host merge.

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KB = 8;     // slots per key bucket, map/signature.py KB
constexpr int WARPS = 8;  // 32 reads a warp, 256 a block

struct FoldArgs {
  const int32_t* sig;
  const uint8_t* mapped;
  const int32_t* weights;  // null: weight 1
  unsigned long long* key;
  int32_t* count;
  int32_t* sigtab;
  int32_t* ec_count;
  int32_t* overflow;
  int32_t* collisions;
  int64_t B;
  int64_t n_key_buckets;
  int64_t ec_len;
  int C;
  int sig_probe;
  bool vec;  // C % 4 == 0 and sig, sigtab on 16-byte boundaries
};

// Claim (or match) the slot of fingerprint fp; returns the slot or -1 when
// `sig_probe` buckets were full, and sets `won` when this lane claimed it.
__device__ __forceinline__ int64_t claim(unsigned long long* key,
                                         int64_t n_key_buckets, int sig_probe,
                                         unsigned long long fp, uint32_t h1,
                                         uint32_t h2, bool& won) {
  int64_t cursor =
      seekmer::sig_slot_hash(h1, h2) & (uint32_t)(n_key_buckets - 1);
  won = false;
  for (int r = 0; r < sig_probe; ++r) {
    unsigned long long* bk = key + cursor * KB;
    unsigned long long view[KB];
#pragma unroll
    for (int q = 0; q < KB / 2; ++q) {
      const uint4 u = __ldcg(reinterpret_cast<const uint4*>(bk) + q);
      view[2 * q] = u.x | ((unsigned long long)u.y << 32);
      view[2 * q + 1] = u.z | ((unsigned long long)u.w << 32);
    }
    uint32_t empty = 0;
    int hit = -1;
#pragma unroll
    for (int j = KB - 1; j >= 0; --j) {
      if (view[j] == fp) hit = j;
      if (view[j] == 0ull) empty |= 1u << j;
    }
    if (hit >= 0) return cursor * KB + hit;
    while (empty) {
      const int j = __ffs(empty) - 1;
      empty &= empty - 1;
      const unsigned long long cur = atomicCAS(bk + j, 0ull, fp);
      if (cur == 0ull || cur == fp) {
        won = cur == 0ull;
        return cursor * KB + j;
      }
    }
    cursor = (cursor + 1) & (n_key_buckets - 1);
  }
  return -1;
}

template <bool AUDIT>
__global__ void __launch_bounds__(WARPS * 32) fold_kernel(FoldArgs a) {
  extern __shared__ int4 smem[];  // WARPS x 32 rows x C int32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = a.C;
  int32_t* wrows = reinterpret_cast<int32_t*>(smem) + warp * 32 * C;
  const int32_t* my = wrows + lane * C;
  const int64_t groups = (a.B + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  // every thread goes round the same number of times: grid.sync() below
  const int64_t passes = (groups + stride - 1) / stride;
  for (int64_t p = 0; p < passes; ++p) {
    const int64_t g = p * stride + (int64_t)blockIdx.x * WARPS + warp;
    const int64_t b0 = g * 32, b = b0 + lane;
    const int nrows = g < groups ? (int)min((int64_t)32, a.B - b0) : 0;
    int w = 0;
    if (lane < nrows && a.mapped[b]) w = a.weights ? a.weights[b] : 1;
    __syncwarp();  // the previous pass's audit has read the rows
    const int n = nrows * C;
    const int32_t* src = a.sig + b0 * C;
    int t0 = 0;
    if (a.vec) {
      const int n4 = n >> 2;
      for (int t = lane; t < n4; t += 32) {
        reinterpret_cast<int4*>(wrows)[t] =
            reinterpret_cast<const int4*>(src)[t];
      }
      t0 = n4 << 2;
    }
    for (int t = t0 + lane; t < n; t += 32) wrows[t] = src[t];
    __syncwarp();

    int64_t slot = -1;
    bool matched = false;
    if (w > 0) {
      const int32_t r0 = my[0];
      const bool single =
          r0 != seekmer::SIG_PAD && (C == 1 || my[1] == seekmer::SIG_PAD);
      if (a.ec_len > 1 && single) {  // exact per-EC vector; last slot: dump
        if (r0 >= 0 && r0 < a.ec_len - 1) atomicAdd(&a.ec_count[r0], w);
      } else {
        uint32_t h1 = 0x2545F491u, h2 = 0x8F1BBCDCu;
        if (a.vec) {
          for (int q = 0; q < C / 4; ++q) {
            const int4 r = reinterpret_cast<const int4*>(my)[q];
            seekmer::sig_fingerprint_step(h1, h2, (uint32_t)r.x);
            seekmer::sig_fingerprint_step(h1, h2, (uint32_t)r.y);
            seekmer::sig_fingerprint_step(h1, h2, (uint32_t)r.z);
            seekmer::sig_fingerprint_step(h1, h2, (uint32_t)r.w);
          }
        } else {
          for (int c = 0; c < C; ++c) {
            seekmer::sig_fingerprint_step(h1, h2, (uint32_t)my[c]);
          }
        }
        if (h1 == 0 && h2 == 0) h1 = 1;  // (0, 0) marks an empty slot
        const unsigned long long fp =
            (unsigned long long)h1 | ((unsigned long long)h2 << 32);
        bool won;
        slot = claim(a.key, a.n_key_buckets, a.sig_probe, fp, h1, h2, won);
        if (slot < 0) {
          atomicAdd(a.overflow, w);
        } else {
          atomicAdd(&a.count[slot], w);
          matched = !won;
          if (won) {
            int32_t* dst = a.sigtab + slot * C;
            if (a.vec) {
              for (int q = 0; q < C / 4; ++q) {
                reinterpret_cast<int4*>(dst)[q] =
                    reinterpret_cast<const int4*>(my)[q];
              }
            } else {
              for (int c = 0; c < C; ++c) dst[c] = my[c];
            }
          }
        }
      }
    }
    if constexpr (AUDIT) {
      cg::this_grid().sync();
      if (matched) {
        const int32_t* st = a.sigtab + slot * C;
        bool differ = false;
        if (a.vec) {
          for (int q = 0; q < C / 4; ++q) {
            const int4 s = __ldcg(reinterpret_cast<const int4*>(st) + q);
            const int4 r = reinterpret_cast<const int4*>(my)[q];
            differ |= s.x != r.x || s.y != r.y || s.z != r.z || s.w != r.w;
          }
        } else {
          for (int c = 0; c < C; ++c) differ |= __ldcg(st + c) != my[c];
        }
        if (differ) atomicAdd(a.collisions, w);
      }
    }
  }
}

__global__ void empty_kernel() {}

__global__ void empty_cooperative_kernel() { cg::this_grid().sync(); }

// Blocks of fold_kernel<true> the card holds at once, by device and bytes
// of shared memory a block (cached: the query costs host time every call).
int cooperative_blocks(int device, size_t smem) {
  static std::mutex mu;
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int cached_blocks = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (device != cached_device || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_kernel<true>,
                                                  WARPS * 32, smem);
    cached_device = device;
    cached_smem = smem;
    cached_blocks = sms * per_sm;
  }
  return cached_blocks;
}

}  // namespace

extern "C" int seekmer_accumulate(const void* sig, const void* mapped,
                                  const void* weights, void* key, void* count,
                                  void* sigtab, void* ec_count,
                                  void* overflow, void* collisions,
                                  void* stream, int64_t device, int64_t B,
                                  int64_t C, int64_t n_key_buckets,
                                  int64_t ec_len, int64_t sig_probe,
                                  int64_t audit) {
  if (B <= 0) return (int)cudaSuccess;
  cudaSetDevice((int)device);
  FoldArgs a{(const int32_t*)sig, (const uint8_t*)mapped,
             (const int32_t*)weights, (unsigned long long*)key,
             (int32_t*)count, (int32_t*)sigtab, (int32_t*)ec_count,
             (int32_t*)overflow, (int32_t*)collisions, B, n_key_buckets,
             ec_len, (int)C, (int)sig_probe,
             C % 4 == 0 && (uintptr_t)sig % 16 == 0 &&
                 (uintptr_t)sigtab % 16 == 0};
  const size_t smem = (size_t)WARPS * 32 * C * sizeof(int32_t);
  const int64_t need = seekmer::grid_for((B + 31) / 32, WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    auto fn = audit ? (const void*)fold_kernel<true>
                    : (const void*)fold_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (!audit) {
    fold_kernel<false><<<(unsigned)need, WARPS * 32, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const int cap = cooperative_blocks((int)device, smem);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned grid = (unsigned)std::min<int64_t>(need, cap);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)fold_kernel<true>,
                                          grid, WARPS * 32, args, smem, st);
}

// An empty launch of `blocks` x `threads` (cooperative: one grid barrier):
// the floor under A1's launch time. Counts nothing.
extern "C" int seekmer_empty_launch(void* stream, int64_t device,
                                    int64_t blocks, int64_t threads,
                                    int64_t cooperative) {
  cudaSetDevice((int)device);
  cudaStream_t st = (cudaStream_t)stream;
  if (!cooperative) {
    empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, st>>>();
    return (int)cudaGetLastError();
  }
  void* none[] = {nullptr};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)empty_cooperative_kernel, (unsigned)blocks,
      (unsigned)threads, none, 0, st);
}
