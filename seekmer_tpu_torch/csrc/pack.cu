// K1: canonical k-mer window packing with the 2-bit unpack fused in.
//
// Replaces seekmer_tpu/ops/pack_pallas.py `_pack_kernel` (called through
// `pack_canonical_pallas`) together with ops/kmer_pack.py
// `unpack_codes_2bit`: the kernel reads the 2-bit packed rows and the
// invalid-base bitmask that the host uploads, so the [B, L] code plane is
// never written to device memory.
//
// What bounds it on Hopper: per window it writes 9 bytes (hi, lo, valid)
// and reads k 2-bit bases; neighbouring threads read overlapping bytes of
// one row, which L1 serves. The output's device-memory floor is 61 MB for
// 65,536 x 104 windows, about 18 us at 3.35 TB/s, but the kernel measures
// about 20x that: it is bound by its per-window loop of k byte loads and
// bit operations (one thread per window, no reuse between neighbouring
// windows). A rolling form that shifts one base in per window is the
// later optimisation.

#include "common.cuh"

namespace {

__global__ void pack_kernel(const uint8_t* __restrict__ packed,
                            const uint8_t* __restrict__ bad,
                            const int32_t* __restrict__ lengths,
                            int32_t* __restrict__ hi_out,
                            int32_t* __restrict__ lo_out,
                            uint8_t* __restrict__ valid_out, int64_t B,
                            int64_t L, int64_t P, int k) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * P) return;
  int64_t b = idx / P;
  int p = (int)(idx - b * P);
  const uint8_t* prow = packed + b * ((L + 3) / 4);
  const uint8_t* brow = bad + b * ((L + 7) / 8);
  const int n_hi = k / 2;
  const int n_lo = k - n_hi;
  uint32_t hf = 0, lf = 0, hr = 0, lr = 0;
  bool any_bad = false;
  for (int i = 0; i < k; ++i) {
    int j = p + i;
    uint32_t c = (prow[j >> 2] >> (2 * (j & 3))) & 3u;
    bool is_bad = (brow[j >> 3] >> (j & 7)) & 1u;
    any_bad |= is_bad;
    uint32_t s = is_bad ? 0u : c;  // invalid bases pack as A, like the jnp form
    if (i < n_hi) {
      hf |= s << (2 * (n_hi - 1 - i));
    } else {
      lf |= s << (2 * (n_lo - 1 - (i - n_hi)));
    }
    int r = k - 1 - i;  // reverse-complement base r reads position i
    uint32_t rc = 3u - s;
    if (r < n_hi) {
      hr |= rc << (2 * (n_hi - 1 - r));
    } else {
      lr |= rc << (2 * (n_lo - 1 - (r - n_hi)));
    }
  }
  bool use_f = (hf < hr) || (hf == hr && lf <= lr);
  hi_out[idx] = (int32_t)(use_f ? hf : hr);
  lo_out[idx] = (int32_t)(use_f ? lf : lr);
  valid_out[idx] = (p + k <= lengths[b]) && !any_bad;
}

}  // namespace

extern "C" int seekmer_pack_canonical(const void* packed, const void* bad,
                                      const void* lengths, void* hi, void* lo,
                                      void* valid, void* stream,
                                      int64_t device, int64_t B, int64_t L,
                                      int64_t k) {
  cudaSetDevice((int)device);
  int64_t P = L - k + 1;
  if (B * P > 0) {
    const int threads = 256;
    pack_kernel<<<seekmer::grid_for(B * P, threads), threads, 0,
                  (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)bad, (const int32_t*)lengths,
        (int32_t*)hi, (int32_t*)lo, (uint8_t*)valid, B, L, P, (int)k);
  }
  return (int)cudaGetLastError();
}
