// K1: canonical k-mer window packing with the 2-bit unpack fused in.
//
// Replaces seekmer_tpu/ops/pack_pallas.py `_pack_kernel` (called through
// `pack_canonical_pallas`) together with ops/kmer_pack.py
// `unpack_codes_2bit`: the kernel reads the 2-bit packed rows and the
// invalid-base bitmask that the host uploads, so the [B, L] code plane is
// never written to device memory.
//
// What bounds it on Hopper: per window it writes 9 bytes (hi, lo, valid)
// and reads a quarter byte; 65,536 x 104 windows write 61 MB, about 18 us
// at 3.35 TB/s. The first form (one thread per window, a loop of k byte
// loads and a dozen bit operations per base, ~350 operations a window) was
// bound by instructions at ~20x that. This form does each window in closed
// form, with no loop over k:
//
//   - a block stages a tile of rows' packed and bad bytes in shared memory
//     with 16-byte loads, at their global alignment so the interior moves
//     as int4 for any row stride (any L), and its rows' lengths;
//   - a thread takes 4 consecutive windows of a row, consecutive threads
//     the next 4, so the stores of hi, lo and valid are coalesced 16-, 16-
//     and 4-byte stores where the output's layout allows;
//   - base j sits at bit 2j of the row read as little-endian words, so the
//     32 bases from the quad's first window are W, a funnel shift of three
//     32-bit words; the quad's k + 3 bad bits are a funnel shift of two
//     words of the bitmask, cleared from W (bad bases pack as A, as the
//     plain version packs them);
//   - window q of the quad is then computed in closed form from W and its
//     base reversal Bs, computed once a quad (kmer.cuh, shared with K5):
//     canonical = min(forward, reverse complement) as 2k-bit integers;
//     hi = canon >> 2 n_lo, lo = the low 2 n_lo bits.
//
// That is ~30 operations a window, the quad's loads and reversal shared.
//
// Paired batches write both mates into one [B, W] output: the kernel takes
// the output's row stride and a column offset, so the map step needs no
// concatenation of the mates.

#include <algorithm>

#include "common.cuh"
#include "kmer.cuh"

namespace {

constexpr int kThreads = 256;
// Windows a block takes: its rows are as many as fill this, 1 to 1024.
constexpr int kWindowsPerBlock = 4096;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Bytes of a shared region holding `n` bytes staged at an offset of up to 15
// (see `stage`), plus the 12 bytes the window reads may run past their row
// (whatever they find there is masked off).
__host__ __device__ inline int region(int n) { return round16(15 + n + 16); }

// Copies the n bytes at src into dst (16-byte aligned shared memory) at
// offset a = src & 15, so 16-byte aligned global chunks land on 16-byte
// aligned shared ones: the interior moves as int4, the two edge chunks
// byte by byte so nothing outside [src, src + n) is read. Returns a.
__device__ __forceinline__ int stage(uint8_t* dst, const uint8_t* src, int n) {
  const int a = (int)((uintptr_t)src & 15);
  const int chunks = (a + n + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    if (c > 0 && c < chunks - 1) {
      reinterpret_cast<int4*>(dst)[c] =
          __ldg(reinterpret_cast<const int4*>(src - a) + c);
    } else {
      for (int b = 0; b < 16; ++b) {
        int i = c * 16 + b - a;
        if (i >= 0 && i < n) dst[c * 16 + b] = src[i];
      }
    }
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ bad,
            const int32_t* __restrict__ lengths, int32_t* __restrict__ hi_out,
            int32_t* __restrict__ lo_out, uint8_t* __restrict__ valid_out,
            int64_t B, int L, int k, int rows_per_block, int64_t out_stride,
            int64_t out_col, bool vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = L - k + 1;
  const int Q = (P + 3) >> 2;   // quads of windows a row
  const int Sp = (L + 3) >> 2;  // packed bytes a row
  const int Sb = (L + 7) >> 3;  // bad-bitmask bytes a row
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int R = (int)min((long long)rows_per_block, (long long)(B - r0));

  uint8_t* s_pk = smem;
  uint8_t* s_bd = s_pk + region(rows_per_block * Sp);
  int32_t* s_len =
      reinterpret_cast<int32_t*>(s_bd + region(rows_per_block * Sb));
  const int a_pk = stage(s_pk, packed + r0 * Sp, R * Sp);
  const int a_bd = stage(s_bd, bad + r0 * Sb, R * Sb);
  for (int i = threadIdx.x; i < R; i += blockDim.x) s_len[i] = lengths[r0 + i];
  __syncthreads();

  const uint32_t* pw = reinterpret_cast<const uint32_t*>(s_pk);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(s_bd);
  const int lo_bits = 2 * (k - k / 2);
  const uint32_t maskk = (1u << k) - 1;
  const uint32_t mask_quad = 0xffffffffu >> (29 - k);  // k + 3 bad bits

  // a thread takes the 4 windows p0..p0+3 of row r: quad t of the tile is
  // (row t / Q, p0 = 4 (t % Q)), kept incrementally
  int r = threadIdx.x / Q, p0 = 4 * (threadIdx.x % Q);
  const int dr = kThreads / Q, dp = 4 * (kThreads % Q);
  for (int t = threadIdx.x; t < R * Q; t += kThreads) {
    // the 32 bases from p0 (byte p0 / 4 of the row) and their k + 3 bad
    // bits, which cover the quad's windows
    const uint32_t X = 8u * (a_pk + r * Sp + (p0 >> 2));
    const uint32_t i = X >> 5, s = X & 31;
    const uint32_t w0 = pw[i], w1 = pw[i + 1], w2 = pw[i + 2];
    const uint32_t Y = 8u * (a_bd + r * Sb) + p0;
    const uint32_t j = Y >> 5;
    const uint32_t nb =
        __funnelshift_r(bw[j], bw[j + 1], Y & 31) & mask_quad;
    const uint64_t W = seekmer::clear_bad(
        (uint64_t)__funnelshift_r(w1, w2, s) << 32 | __funnelshift_r(w0, w1, s),
        nb);
    const uint64_t Bs = seekmer::reverse_bases(W);
    const int len = s_len[r];

    int32_t h[4], l[4];
    uint8_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t canon = seekmer::canonical_window(W, Bs, q, k);
      h[q] = (int32_t)(canon >> lo_bits);
      l[q] = (int32_t)(canon & ((1ull << lo_bits) - 1));
      v[q] = (p0 + q + k <= len) && ((nb >> q) & maskk) == 0;
    }

    const int64_t o = (r0 + r) * out_stride + out_col + p0;
    if (vec && p0 + 4 <= P) {
      *reinterpret_cast<int4*>(hi_out + o) = make_int4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<int4*>(lo_out + o) = make_int4(l[0], l[1], l[2], l[3]);
      *reinterpret_cast<uchar4*>(valid_out + o) =
          make_uchar4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (p0 + q < P) {
          hi_out[o + q] = h[q];
          lo_out[o + q] = l[q];
          valid_out[o + q] = v[q];
        }
      }
    }

    r += dr;
    p0 += dp;
    if (p0 >= 4 * Q) {
      p0 -= 4 * Q;
      ++r;
    }
  }
}

}  // namespace

extern "C" int seekmer_pack_canonical(const void* packed, const void* bad,
                                      const void* lengths, void* hi, void* lo,
                                      void* valid, void* stream,
                                      int64_t device, int64_t B, int64_t L,
                                      int64_t k, int64_t out_stride,
                                      int64_t out_col) {
  cudaSetDevice((int)device);
  const int64_t P = L - k + 1;
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  const int rows =
      (int)std::max<int64_t>(1, std::min<int64_t>(1024, kWindowsPerBlock / P));
  // 16-byte stores of a quad's hi and lo, 4 of its valid bytes, where
  // every quad of the output starts on such a boundary
  const bool vec = out_stride % 4 == 0 && out_col % 4 == 0 &&
                   (uintptr_t)hi % 16 == 0 && (uintptr_t)lo % 16 == 0 &&
                   (uintptr_t)valid % 4 == 0;
  const int Sp = (int)((L + 3) / 4), Sb = (int)((L + 7) / 8);
  const size_t smem =
      (size_t)region(rows * Sp) + region(rows * Sb) + 4 * (size_t)rows;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_kernel<<<seekmer::grid_for(B, rows), kThreads, smem,
                (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)bad, (const int32_t*)lengths,
      (int32_t*)hi, (int32_t*)lo, (uint8_t*)valid, B, (int)L, (int)k, rows,
      out_stride, out_col, vec);
  return (int)cudaGetLastError();
}
