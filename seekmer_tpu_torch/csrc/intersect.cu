// I2: intersect the member lists of the multi-EC signatures.
//
// Replaces no TPU kernel: the JAX package resolves signatures on the host
// (seekmer_tpu/map/driver.py:638 `resolve_signatures`, a Python loop of
// np.intersect1d over every signature of two or more ECs), and the port
// did the same until this kernel: ~23 us of interpreter and call overhead
// a signature, tens of thousands of signatures a sample, with the card
// idle. Here one launch intersects them all.
//
// A row is a signature: C EC ids, SIG_PAD where there is none. Each EC's
// members are ec_transcripts[ec_offsets[ec] : ec_offsets[ec + 1]], sorted
// and unique. The row's intersection goes, sorted ascending (as
// np.intersect1d returns it), to out[out_start[row] ...], a slot the
// wrapper sized from the row's shortest list (its exclusive scan of those
// lengths), and its length to out_len[row], 0 for an empty intersection.
//
// One warp a row, grid-striding over the rows. The lanes read the row 32
// columns at a time and keep each real EC's (start, length) in shared
// memory, compacted in column order by a ballot; a warp shuffle reduction
// picks the shortest list. Its members are the candidates: each lane takes
// one, 32 at a time, for lists of any length, and binary-searches it in
// every other list of the row (lists are short and stay in L1 or L2). The
// survivors are compacted in order by __ballot_sync and __popc into the
// row's slot, so no lane needs another's result and the kernel allocates
// nothing.
//
// What bounds it on Hopper: the bytes. Each row read once, each list's
// (start, end) and members once, each survivor and each length written
// once: about 17 MB for a paralog sample's ~70,000 signatures and ~1.5M
// members, ~5 us at 3.35 TB/s. The binary searches touch a list member a
// few times each, in cache. Its launch and the wrapper's read-backs, not
// the kernel, set the time a call takes.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Whether sorted a[0, n) holds x: a lower bound, then one compare.
__device__ __forceinline__ bool holds(const int32_t* __restrict__ a,
                                      int32_t n, int32_t x) {
  int32_t lo = 0, len = n;
  while (len > 0) {
    const int32_t half = len >> 1;
    if (__ldg(a + lo + half) < x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo < n && __ldg(a + lo) == x;
}

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ transcripts,
                 const int64_t* __restrict__ out_start,
                 int32_t* __restrict__ out, int32_t* __restrict__ out_len,
                 int64_t n_rows, int C) {
  extern __shared__ int2 lists[];  // (start, length), C a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;
  int2* mine = lists + (int64_t)warp * C;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < n_rows;
       r += (int64_t)gridDim.x * kWarps) {  // uniform across the warp
    const int32_t* row = rows + r * C;
    int n = 0;  // real ECs so far
    // the shortest list as (length << 32 | its place): the first of the
    // shortest on a tie
    unsigned long long best = ~0ull;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const int32_t ec = c < C ? __ldg(row + c) : seekmer::SIG_PAD;
      const bool real = ec != seekmer::SIG_PAD;
      const unsigned vote = __ballot_sync(kFull, real);
      unsigned long long key = ~0ull;
      if (real) {
        const int at = n + __popc(vote & below);
        const int32_t s = __ldg(offsets + ec);
        const int32_t len = __ldg(offsets + ec + 1) - s;
        mine[at] = make_int2(s, len);
        key = ((unsigned long long)(uint32_t)len << 32) | (uint32_t)at;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long other = __shfl_xor_sync(kFull, key, d);
        key = other < key ? other : key;
      }
      best = key < best ? key : best;
      n += __popc(vote);
    }
    __syncwarp();
    const int shortest = n ? (int)(uint32_t)best : 0;
    const int32_t n_cand = n ? (int32_t)(best >> 32) : 0;
    const int32_t* cand = transcripts + (n ? mine[shortest].x : 0);
    int32_t* slot = out + out_start[r];
    int32_t kept = 0;
    for (int32_t i0 = 0; i0 < n_cand; i0 += 32) {  // uniform
      const int32_t i = i0 + lane;
      bool keep = i < n_cand;
      const int32_t t = keep ? __ldg(cand + i) : 0;
      for (int j = 0; j < n && __any_sync(kFull, keep); ++j) {
        if (j == shortest || !keep) continue;
        const int2 e = mine[j];
        keep = holds(transcripts + e.x, e.y, t);
      }
      const unsigned vote = __ballot_sync(kFull, keep);
      if (keep) slot[kept + __popc(vote & below)] = t;
      kept += __popc(vote);
    }
    if (lane == 0) out_len[r] = kept;
    __syncwarp();  // the next row reuses this warp's lists
  }
}

}  // namespace

// rows: int32[n_rows, C]; offsets: int32[E + 1]; transcripts: int32[nnz];
// out_start: int64[n_rows], the exclusive scan of each row's shortest list
// length; out: int32[sum of those lengths]; out_len: int32[n_rows].
extern "C" int seekmer_intersect(void* rows, void* offsets, void* transcripts,
                                 void* out_start, void* out, void* out_len,
                                 void* stream, int64_t device, int64_t n_rows,
                                 int64_t C) {
  cudaSetDevice((int)device);
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * C * sizeof(int2);
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, (int)device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_kernel,
                                                kThreads, smem);
  const int64_t need = seekmer::grid_for(n_rows, kWarps);
  const unsigned int grid = (unsigned int)std::max<int64_t>(
      1, std::min<int64_t>(need, (int64_t)sms * std::max(per_sm, 1)));
  intersect_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)offsets,
      (const int32_t*)transcripts, (const int64_t*)out_start, (int32_t*)out,
      (int32_t*)out_len, n_rows, (int)C);
  return (int)cudaGetLastError();
}
