// Shared device helpers for the seekmer_tpu_torch kernels.
//
// The hashes are bit-for-bit those of seekmer_tpu/ops/hash.py (murmur3
// fmix32 and the same constants): the host builds the index with the numpy
// forms, the kernels look keys up with these.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace seekmer {

constexpr int32_t SIG_PAD = 0x7FFFFFFF;  // sorts after every real EC id

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_kmer(uint32_t hi, uint32_t lo) {
  return mix32(hi ^ mix32(lo + 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t hash_kmer_stash(uint32_t hi, uint32_t lo) {
  return mix32(lo ^ mix32(hi + 0x7FEB352Du));
}

__device__ __forceinline__ void sig_fingerprint_step(uint32_t& h1, uint32_t& h2,
                                                     uint32_t ec) {
  h1 = mix32(h1 ^ ec);
  h2 = mix32(h2 + ec * 0x9E3779B9u);
}

__device__ __forceinline__ uint32_t sig_slot_hash(uint32_t h1, uint32_t h2) {
  return mix32(h1 ^ (h2 * 0xC2B2AE35u));
}

// Grid size for n work items at `per_block` items per block.
inline unsigned int grid_for(int64_t n, int64_t per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

}  // namespace seekmer
