// K6: fast mode's merge of per-segment contributions into signatures.
//
// Replaces seekmer_tpu/ops/probe.py `two_phase_signatures`' uniform merge
// (:481-490): two row sorts over the (B, n_seg x C) staging buffer, a
// duplicate mask between them, and the over / force_unmapped / mapped
// rule. Here the staging buffer is never built. A thread takes a read;
// each of its segments contributes a sorted distinct list: the unit's
// dense signature row (C values, SIG_PAD after the last) read through its
// slot, or its one sampled EC (nothing when SIG_PAD). A two-way merge of
// at most two such lists gives the sorted distinct set, whose first C
// values are the signature; more than C of them is "over". A re-probed
// segment with hits that is unmapped on its own (more than C distinct
// ECs) forces the read unmapped. mapped = some value & !over & !forced.
//
// What bounds it on Hopper: the bytes it moves, ~8 B a segment, 4 B of a
// read's single EC, the units' 64-byte rows and the 64-byte signature it
// writes (~5-7 MB a paired batch of 65,536): a few microseconds, so its
// launch floor dominates. Each thread writes its signature into shared
// memory (rows at an odd stride, so the threads' writes fall in distinct
// banks), and the block then writes its reads' rows, one contiguous span
// of the output, coalesced: the first form wrote each thread's row straight
// to device memory, 16 partial-sector stores a read from every lane of a
// warp at once, and took ~4x its launch floor on an H100.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Value i of segment g's list: the unit's row, or the single EC.
__device__ __forceinline__ int32_t entry(int sl, int32_t one,
                                         const int32_t* __restrict__ sig_d,
                                         int C, int i) {
  if (sl >= 0) return i < C ? __ldg(sig_d + (int64_t)sl * C + i)
                            : seekmer::SIG_PAD;
  return i == 0 ? one : seekmer::SIG_PAD;
}

// Read b's signature into `out` (C values) and its mapped flag.
__device__ __forceinline__ void merge_read(
    const int32_t* __restrict__ single, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ sig_d, const uint8_t* __restrict__ mapped_d,
    int32_t* out, uint8_t* __restrict__ mapped, int64_t b, int n_seg,
    int C) {
  const int s0 = slot[b * n_seg];
  const int32_t one0 = single[b * n_seg];
  const int s1 = n_seg > 1 ? slot[b * n_seg + 1] : -1;
  const int32_t one1 = n_seg > 1 ? single[b * n_seg + 1] : seekmer::SIG_PAD;
  bool forced = false;
  if (s0 >= 0) forced |= __ldg(sig_d + (int64_t)s0 * C) != seekmer::SIG_PAD &&
                         !mapped_d[s0];
  if (s1 >= 0) forced |= __ldg(sig_d + (int64_t)s1 * C) != seekmer::SIG_PAD &&
                         !mapped_d[s1];

  int i0 = 0, i1 = 0, n = 0;
  for (;;) {
    const int32_t a = entry(s0, one0, sig_d, C, i0);
    const int32_t c = entry(s1, one1, sig_d, C, i1);
    const int32_t v = min(a, c);
    if (v == seekmer::SIG_PAD) break;
    i0 += a == v;
    i1 += c == v;
    if (n < C) out[n] = v;
    ++n;
  }
  for (int i = n; i < C; ++i) out[i] = seekmer::SIG_PAD;
  mapped[b] = n > 0 && n <= C && !forced;
}

// Shared memory of a block: its reads' signature rows at stride C | 1.
inline size_t smem_bytes(int C) {
  return sizeof(int32_t) * (size_t)kThreads * (C | 1);
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ single,
             const int32_t* __restrict__ slot,
             const int32_t* __restrict__ sig_d,
             const uint8_t* __restrict__ mapped_d, int32_t* __restrict__ sig,
             uint8_t* __restrict__ mapped, int64_t B, int n_seg, int C) {
  extern __shared__ int32_t s_sig[];
  const int stride = C | 1;
  const int64_t b0 = (int64_t)blockIdx.x * kThreads;
  const int R = (int)min((long long)kThreads, (long long)(B - b0));
  if ((int)threadIdx.x < R) merge_read(single, slot, sig_d, mapped_d,
                                       s_sig + threadIdx.x * stride, mapped,
                                       b0 + threadIdx.x, n_seg, C);
  __syncthreads();
  int32_t* out = sig + b0 * C;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    out[i] = s_sig[(i / C) * stride + i % C];
  }
}

}  // namespace

extern "C" int seekmer_merge_staging(const void* single, const void* slot,
                                     const void* sig_d, const void* mapped_d,
                                     void* sig, void* mapped, void* stream,
                                     int64_t device, int64_t B, int64_t n_seg,
                                     int64_t C) {
  cudaSetDevice((int)device);
  if (B <= 0) return (int)cudaGetLastError();
  if (n_seg < 1 || n_seg > 2 || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes((int)C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merge_kernel<<<seekmer::grid_for(B, kThreads), kThreads, smem,
                 (cudaStream_t)stream>>>(
      (const int32_t*)single, (const int32_t*)slot, (const int32_t*)sig_d,
      (const uint8_t*)mapped_d, (int32_t*)sig, (uint8_t*)mapped, B, (int)n_seg,
      (int)C);
  return (int)cudaGetLastError();
}
