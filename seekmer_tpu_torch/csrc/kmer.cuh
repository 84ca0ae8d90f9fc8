// Canonical k-mer windows in closed form from 2-bit packed reads: the
// window arithmetic of K1 (pack.cu) and K5 (sample.cu).
//
// A row packs base j at bits 2 (j % 4) of byte j / 4, so read as
// little-endian words base j sits at bit 2j. W below holds 32 bases from
// some base p, base p + i at bits 2i. The reverse complement of the window
// starting at base p + q wants base i complemented at bits 2i, which W
// already is: R = ~(W >> 2q) & mask(2k). The forward value F (the window's
// first base in the top group) reverses the 2-bit groups: with Bs =
// reverse_bases(W), F = (Bs << 2q) >> (64 - 2k). canonical = min(F, R) as
// 2k-bit integers, the plain version's (hi, lo) lexicographic rule, since
// hi is the top 2 * (k / 2) bits (2k <= 58).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace seekmer {

// Bit i of x moves to bit 2i.
__device__ __forceinline__ uint64_t spread2(uint32_t x) {
  uint64_t v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  return (v | (v << 1)) & 0x5555555555555555ull;
}

// W with the bases whose bit is set in nb (bit i = base i) packed as A, as
// the plain version packs bad bases.
__device__ __forceinline__ uint64_t clear_bad(uint64_t W, uint32_t nb) {
  const uint64_t g = spread2(nb);
  return W & ~(g | (g << 1));
}

// The 2-bit groups of W in reverse order.
__device__ __forceinline__ uint64_t reverse_bases(uint64_t W) {
  return __brevll(((W >> 1) & 0x5555555555555555ull) |
                  ((W & 0x5555555555555555ull) << 1));
}

// The canonical 2k-bit value of the window starting at base q of W.
__device__ __forceinline__ uint64_t canonical_window(uint64_t W, uint64_t Bs,
                                                     int q, int k) {
  const uint64_t R = ~(W >> (2 * q)) & ((1ull << (2 * k)) - 1);
  const uint64_t F = (Bs << (2 * q)) >> (64 - 2 * k);
  return F <= R ? F : R;
}

}  // namespace seekmer
