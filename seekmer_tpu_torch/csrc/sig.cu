// K3: per-read EC signature (sorted distinct EC ids, capped at C).
//
// Replaces seekmer_tpu/ops/sig_pallas.py `_sig_kernel` with its two
// `_bitonic_sort_rows` passes (called through `read_signatures_pallas`).
// The TPU form built a compare-exchange network from pairs of circular lane
// rolls over a (block, W >= 128) plane and sorted the whole padded row
// twice, the second time to move the distinct ids to the front.
//
// What bounds it on Hopper: bytes. A paired config-2 batch (65,536 reads x
// 208 windows) reads 54.5 MB of ecs and 13.6 MB of valid and writes 4.2 MB
// of signatures, ~72 MB, 0.0216 ms at 3.35 TB/s. Sorting 208 values a read
// (the first port: 36 bitonic stages in shared memory) made it bound by
// shared memory and instruction issue instead, to find what is almost
// always 1-5 distinct ids: consecutive k-mers of a read fall in the same EC
// except at junctions and misses.
//
// The design. One warp owns one read and holds its windows in registers,
// NV a lane (NV = 8 at W = 256, up to 32 at the widest row, P = 1,024):
//
//  * Loads: with P % 4 == 0 and aligned rows (both configs), lane l loads
//    windows 128 g + 4 l .. + 3 of group g as one 16-byte vector of ecs
//    and one 4-byte word of valid; otherwise window 32 g + l, one by one.
//    Either way a lane's windows follow the row's order. A missed (< 0) or
//    invalid window becomes SIG_PAD, as in the plain version.
//  * Run heads: a window is a head when it is not SIG_PAD and differs from
//    the window before it (from the lane before, `__shfl_up_sync`, or from
//    lane 31's previous group). Every distinct id heads at least one run; an
//    id that recurs after a miss heads two, and the sort below drops the
//    copy. H, the warp's head count, comes from a warp scan of per-lane
//    counts.
//  * H <= 32 (nearly every read): the heads are compacted one to a lane
//    through 128 bytes of shared memory, sorted by a 15-step
//    `__shfl_xor_sync` bitonic network, and every value equal to its left
//    neighbour is dropped; a ballot ranks the rest, and lanes < C store the
//    signature row as one coalesced run (64 bytes at C = 16).
//  * H > 32 (rare; exact all the same): the heads, SIG_PAD elsewhere, are
//    sorted in registers, the whole 32 NV values: in-lane compare-exchanges
//    while the stride is below NV, `__shfl_xor_sync` above. Distinct ids are
//    flagged against their left neighbour and compacted by a warp scan.
//    The warp picks its path itself; nothing falls back to a library sort.
//
// mapped = 1 <= n_distinct <= C; the first C distinct ids are written even
// when there are more (the plain version's `sort(distinct)[:, :C]`).
//
// Segments (fusion mode, seekmer_tpu/map/driver.py:298-309): a read's row
// may be two segments of P windows, a pair's mates, whose signatures go
// side by side into a row of 2 C ids, mapped the AND of the two. The warp
// runs the steps above once a segment, each with its own run-head pass.
//
// Complex reads: given a counter, the kernel adds to it the reads with more
// than C distinct ids in some segment: lane 0 of the read's warp adds 1,
// only for such a read. A block-wide sum (a barrier at the block's end, one
// atomic a block) cost ~10% of the kernel's time on a paired config-2-shaped
// batch on an H100 (0.0416-0.0423 against 0.0376-0.0386 ms), its registers
// at W = 208 growing from 32 to 45 a thread. Complex reads are rare (4-10 in
// a sample of 1,048,576 pairs of the gencode_paralog_pe100 world), so their
// atomics cost nothing measurable. Without a counter the kernel is the one
// that counts nothing (COUNT = false).

#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // reads a 256-thread block
constexpr uint32_t FULL = 0xffffffffu;
constexpr int32_t NONE = -1;  // "no window before": never a masked value

// One bitonic compare-exchange step over the warp's 32 NV values, value k
// of lane l being element l NV + k.
template <int NV, int SIZE, int STRIDE>
__device__ __forceinline__ void sort_step(int32_t (&x)[NV], int lane) {
  if constexpr (STRIDE < NV) {  // both elements in this lane
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((k & STRIDE) == 0) {
        const bool up = ((lane * NV + k) & SIZE) == 0;
        const int32_t a = x[k], b = x[k | STRIDE];
        x[k] = up ? min(a, b) : max(a, b);
        x[k | STRIDE] = up ? max(a, b) : min(a, b);
      }
    }
  } else {  // partner in lane l ^ (STRIDE / NV), same k
    const bool lower = (lane & (STRIDE / NV)) == 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const bool up = ((lane * NV + k) & SIZE) == 0;
      const int32_t y = __shfl_xor_sync(FULL, x[k], STRIDE / NV);
      x[k] = (lower == up) ? min(x[k], y) : max(x[k], y);
    }
  }
}

template <int NV, int SIZE, int STRIDE = SIZE / 2>
__device__ __forceinline__ void sort_merge(int32_t (&x)[NV], int lane) {
  sort_step<NV, SIZE, STRIDE>(x, lane);
  if constexpr (STRIDE > 1) sort_merge<NV, SIZE, STRIDE / 2>(x, lane);
}

// Ascending bitonic sort of the warp's 32 NV values (element l NV + k).
template <int NV, int SIZE = 2>
__device__ __forceinline__ void warp_sort(int32_t (&x)[NV], int lane) {
  sort_merge<NV, SIZE>(x, lane);
  if constexpr (SIZE < 32 * NV) warp_sort<NV, SIZE * 2>(x, lane);
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__device__ __forceinline__ int32_t masked(int32_t e, uint32_t ok) {
  return ok && e >= 0 ? e : seekmer::SIG_PAD;
}

// The signature of one segment of P windows (erow, vrow) into srow (C
// ids), through the warp's 32-int stage s; returns its distinct ids.
// NV windows a lane; G = 4: 16-byte groups (P % 4 == 0, aligned rows),
// G = 1: one window a load.
template <int NV, int G>
__device__ __forceinline__ int segment_signature(
    const int32_t* __restrict__ erow, const uint8_t* __restrict__ vrow,
    int32_t* __restrict__ srow, int32_t* s, int P, int C, int lane) {
  int32_t v[NV];
#pragma unroll
  for (int g = 0; g < NV / G; ++g) {
    const int pos = g * 32 * G + lane * G;  // this lane's first window of g
    if constexpr (G == 4) {
      int4 e = make_int4(NONE, NONE, NONE, NONE);
      uint32_t ok = 0;
      if (pos < P) {
        e = *reinterpret_cast<const int4*>(erow + pos);
        ok = *reinterpret_cast<const uint32_t*>(vrow + pos);
      }
      v[4 * g + 0] = masked(e.x, ok & 0xffu);
      v[4 * g + 1] = masked(e.y, ok & 0xff00u);
      v[4 * g + 2] = masked(e.z, ok & 0xff0000u);
      v[4 * g + 3] = masked(e.w, ok & 0xff000000u);
    } else {
      v[g] = pos < P ? masked(erow[pos], vrow[pos]) : seekmer::SIG_PAD;
    }
  }

  // run heads, in the row's order
  uint32_t heads = 0;  // bit k: v[k] heads a run
  int32_t carry = NONE;  // last window of the previous group (lane 31's)
#pragma unroll
  for (int g = 0; g < NV / G; ++g) {
    const int32_t last = v[g * G + G - 1];
    const int32_t up = __shfl_up_sync(FULL, last, 1);
    int32_t prev = lane == 0 ? carry : up;
    carry = __shfl_sync(FULL, last, 31);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int32_t x = v[g * G + e];
      if (x != seekmer::SIG_PAD && x != prev) heads |= 1u << (g * G + e);
      prev = x;
    }
  }
  const int hc = __popc(heads);
  const int incl = warp_inclusive_sum(hc, lane);
  const int H = __shfl_sync(FULL, incl, 31);

  int n;  // distinct ids
  if (H <= 32) {
    int pos = incl - hc;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((heads >> k) & 1u) s[pos++] = v[k];
    }
    __syncwarp();
    int32_t x[1] = {lane < H ? s[lane] : seekmer::SIG_PAD};
    warp_sort<1>(x, lane);
    const int32_t left = __shfl_up_sync(FULL, x[0], 1);
    const bool fresh = x[0] != seekmer::SIG_PAD && (lane == 0 || x[0] != left);
    const uint32_t fm = __ballot_sync(FULL, fresh);
    n = __popc(fm);
    __syncwarp();  // every lane has read its head before s is reused
    if (fresh) {
      const int r = __popc(fm & ((1u << lane) - 1u));
      if (r < C) s[r] = x[0];
    }
    __syncwarp();
    for (int q = lane; q < C; q += 32) {
      srow[q] = q < n ? s[q] : seekmer::SIG_PAD;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!((heads >> k) & 1u)) v[k] = seekmer::SIG_PAD;
    }
    warp_sort<NV>(v, lane);
    const int32_t left = __shfl_up_sync(FULL, v[NV - 1], 1);
    uint32_t fresh = 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int32_t prev = k > 0 ? v[k - 1] : (lane > 0 ? left : NONE);
      if (v[k] != seekmer::SIG_PAD && v[k] != prev) fresh |= 1u << k;
    }
    const int fc = __popc(fresh);
    const int fincl = warp_inclusive_sum(fc, lane);
    n = __shfl_sync(FULL, fincl, 31);
    int r = fincl - fc;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((fresh >> k) & 1u) {
        if (r < C) srow[r] = v[k];
        ++r;
      }
    }
    for (int q = lane; q < C; q += 32) {
      if (q >= n) srow[q] = seekmer::SIG_PAD;
    }
  }
  __syncwarp();  // every lane has read s before the next segment writes it
  return n;
}

// A warp a read of SEGS segments of P windows (a row of SEGS P): segment
// g's signature goes to columns [g C, g C + C) of the read's row, each
// segment with its own run-head pass, so no run joins across a segment's
// end; mapped is the AND of the segments'. SEGS = 2 is fusion mode's pair
// of mates, what the JAX package computes with one signature call a mate.
// SEGS is a template parameter: with a runtime count the dense call took
// 0.0807 ms on a paired config-2 batch on an H100, against 0.0354 so.
// COUNT: n_complex gains each read with a segment of more than C ids.
template <int NV, int G, int SEGS, bool COUNT>
__global__ void __launch_bounds__(WARPS * 32)
    sig_kernel(const int32_t* __restrict__ ecs,
               const uint8_t* __restrict__ valid, int32_t* __restrict__ sig,
               uint8_t* __restrict__ mapped, int32_t* __restrict__ n_complex,
               int64_t B, int P, int C) {
  __shared__ int32_t stage[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= B) return;  // uniform across the warp
  bool all = true, over = false;
#pragma unroll
  for (int g = 0; g < SEGS; ++g) {
    const int64_t seg = b * SEGS + g;
    const int n = segment_signature<NV, G>(ecs + seg * P, valid + seg * P,
                                           sig + seg * C, stage[warp], P, C,
                                           lane);
    all &= n >= 1 && n <= C;
    if constexpr (COUNT) over |= n > C;
  }
  if (lane == 0) {
    mapped[b] = all;
    if constexpr (COUNT) {
      if (over) atomicAdd(n_complex, 1);
    }
  }
}

template <int NV, int SEGS, bool COUNT>
void launch(const void* ecs, const void* valid, void* sig, void* mapped,
            void* n_complex, cudaStream_t stream, int64_t B, int P, int C,
            bool vec) {
  const unsigned grid = seekmer::grid_for(B, WARPS);
  if (vec) {
    sig_kernel<NV, 4, SEGS, COUNT><<<grid, WARPS * 32, 0, stream>>>(
        (const int32_t*)ecs, (const uint8_t*)valid, (int32_t*)sig,
        (uint8_t*)mapped, (int32_t*)n_complex, B, P, C);
  } else {
    sig_kernel<NV, 1, SEGS, COUNT><<<grid, WARPS * 32, 0, stream>>>(
        (const int32_t*)ecs, (const uint8_t*)valid, (int32_t*)sig,
        (uint8_t*)mapped, (int32_t*)n_complex, B, P, C);
  }
}

template <int NV>
void launch_segs(const void* ecs, const void* valid, void* sig, void* mapped,
                 void* n_complex, cudaStream_t stream, int64_t B, int P,
                 int C, int segs, bool vec) {
  if (n_complex == nullptr) {
    if (segs == 1) {
      launch<NV, 1, false>(ecs, valid, sig, mapped, n_complex, stream, B, P,
                           C, vec);
    } else {
      launch<NV, 2, false>(ecs, valid, sig, mapped, n_complex, stream, B, P,
                           C, vec);
    }
  } else if (segs == 1) {
    launch<NV, 1, true>(ecs, valid, sig, mapped, n_complex, stream, B, P, C,
                        vec);
  } else {
    launch<NV, 2, true>(ecs, valid, sig, mapped, n_complex, stream, B, P, C,
                        vec);
  }
}

}  // namespace

// P windows a segment, segs (1 or 2) segments a read (a row of segs P
// windows, a signature row of segs C ids); NV = max(4, next power of two >=
// ceil(P / 32)) windows a lane, P <= 1024. The 16-byte path needs P % 4
// == 0, which also puts every segment after the first on a 16-byte (ecs)
// and 4-byte (valid) boundary. n_complex: an int32 counter of complex
// reads to add to, or null.
extern "C" int seekmer_read_signatures(const void* ecs, const void* valid,
                                       void* sig, void* mapped,
                                       void* n_complex, void* stream,
                                       int64_t device, int64_t B, int64_t P,
                                       int64_t C, int64_t segs) {
  cudaSetDevice((int)device);
  if (B <= 0) return (int)cudaGetLastError();
  if (P > 1024 || C < 1 || segs < 1 || segs > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = P % 4 == 0 && (uintptr_t)ecs % 16 == 0 &&
                   (uintptr_t)valid % 4 == 0;
  auto s = (cudaStream_t)stream;
  const int p = (int)P, c = (int)C, g = (int)segs;
  const int64_t per_lane = (P + 31) / 32;
  if (per_lane <= 4) {
    launch_segs<4>(ecs, valid, sig, mapped, n_complex, s, B, p, c, g, vec);
  } else if (per_lane <= 8) {
    launch_segs<8>(ecs, valid, sig, mapped, n_complex, s, B, p, c, g, vec);
  } else if (per_lane <= 16) {
    launch_segs<16>(ecs, valid, sig, mapped, n_complex, s, B, p, c, g, vec);
  } else {
    launch_segs<32>(ecs, valid, sig, mapped, n_complex, s, B, p, c, g, vec);
  }
  return (int)cudaGetLastError();
}
