// K5: fast mode's phase 1 (sample, probe, classify) in one kernel.
//
// Replaces the XLA code of seekmer_tpu/ops/probe.py `two_phase_signatures`
// up to its fallback rounds (:339-407): there a full-width pack of every
// window (K1 over the batch, map/driver.py:262-264) came first, then a
// gather of the sampled columns, their lookup, the per-segment max and
// all-equal reductions, the staging buffer and the unit mask, each a pass
// of XLA over the batch. Here one launch reads the 2-bit rows the host
// uploaded and writes what phase 2 and the merge need:
//
//   - single int32[B, n_seg]: the segment's one sampled EC, or SIG_PAD;
//   - slot int32[B, n_seg]: the segment's row among the compacted units
//     phase 2 re-probes, -1 when it is not one;
//   - the units' packed rows, bad-bitmask rows and lengths, copied into
//     compacted buffers at their slots (phase 2 then needs no gather), and
//     their number in a device counter.
//
// What bounds it on Hopper: like K2, random reads of bucket rows from a
// table far larger than L2, but only for the sampled windows (~1/s of
// them); the 2-bit rows it reads are ~0.4 bytes a base. Its design:
//
//   - a block takes whole reads, as many as fill 256 sampled lanes (the
//     flattened (read, segment, column) space; at least one read), so a
//     read's segments are classified in the block that looked them up;
//   - a lane computes its sampled window in closed form from the row's
//     bytes (kmer.cuh, K1's arithmetic: no loop over k), and its validity
//     from the length and the bad bits; the warp looks its 32 windows up
//     together with K2's routine (lookup.cuh: 32 hi slabs in flight, the
//     stash probed in the kernel), and stages the ECs in shared memory;
//   - a thread a read then reduces its segments (largest EC, all hits
//     equal), decides resolution, and for a segment that must be
//     re-probed checks that the row has any valid window (a run of k good
//     bases within its length, from the bitmask: not a sampled fact);
//   - needy units take slots through one warp-aggregated atomicAdd a warp
//     on the device counter. Their order is not deterministic; nothing
//     downstream depends on it (the merge reads a unit through its slot).
//
// Sampled columns are static over the padded width: 0, s, 2s, ... below
// P = L - k + 1, then P - 1 (ops/probe.py `sample_columns`).

#include <algorithm>

#include "common.cuh"
#include "kmer.cuh"
#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // <= 64 registers, as K2

struct Mate {
  const uint8_t* packed;  // [B, (L + 3) / 4]
  const uint8_t* bad;     // [B, (L + 7) / 8]
  const int32_t* len;     // [B]
};

// The 32 bases from base c of a 2-bit row of n bytes, base c at bits 0-1;
// bytes past the row read as 0. After the shift at least 29 >= k bases
// are whole.
__device__ __forceinline__ uint64_t bases_from(const uint8_t* row, int n,
                                               int c) {
  const int b0 = c >> 2;
  uint64_t w = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (b0 + i < n) w |= (uint64_t)__ldg(row + b0 + i) << (8 * i);
  }
  return w >> (2 * (c & 3));
}

// Bits c .. c + 28 of a bitmask row of n bytes (bit j of the row = bit
// j % 8 of byte j / 8); bytes past the row read as 0.
__device__ __forceinline__ uint32_t bits_from(const uint8_t* row, int n,
                                              int c) {
  const int b0 = c >> 3;
  uint64_t w = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (b0 + i < n) w |= (uint64_t)__ldg(row + b0 + i) << (8 * i);
  }
  return (uint32_t)(w >> (c & 7));
}

// Whether the first `len` bases of a row hold k consecutive good bases.
__device__ bool has_valid_window(const uint8_t* bad, int len, int k) {
  int run = 0;
  for (int i = 0; i < len; ++i) {
    if ((__ldg(bad + (i >> 3)) >> (i & 7)) & 1) {
      run = 0;
    } else if (++run >= k) {
      return true;
    }
  }
  return false;
}

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sample_kernel(Mate m0, Mate m1, const int32_t* __restrict__ table,
              const int32_t* __restrict__ stash, int32_t* __restrict__ single,
              int32_t* __restrict__ slot, int32_t* __restrict__ count,
              uint8_t* __restrict__ u_packed, uint8_t* __restrict__ u_bad,
              int32_t* __restrict__ u_len, int64_t B, int n_seg, int L, int k,
              int s, int S, int reads_per_block, uint32_t main_mask,
              uint32_t stash_mask, int aux_bits) {
  extern __shared__ int32_t s_ec[];  // [reads_per_block, n_seg, S]
  const int Sp = (L + 3) >> 2, Sb = (L + 7) >> 3, P = L - k + 1;
  const int64_t r0 = (int64_t)blockIdx.x * reads_per_block;
  const int R = (int)min((long long)reads_per_block, (long long)(B - r0));
  const int lanes = R * n_seg * S;
  const int lo_bits = 2 * (k - k / 2);
  const uint32_t maskk = (1u << k) - 1;

  // the sampled lanes, 256 a round; the bound is the block's, so every
  // lane of a warp reaches the warp lookup together
  for (int base = 0; base < lanes; base += kThreads) {
    const int t = base + threadIdx.x;
    bool v = false;
    int32_t khi = 0, klo = 0;
    if (t < lanes) {
      const int u = t / S;  // the block's unit: read u / n_seg, segment
      const Mate& m = u % n_seg ? m1 : m0;
      const int64_t b = r0 + u / n_seg;
      const int c = min((t % S) * s, P - 1);
      const int len = min(m.len[b], L);
      if (c + k <= len &&
          (bits_from(m.bad + b * Sb, Sb, c) & maskk) == 0) {
        v = true;
        const uint64_t W = bases_from(m.packed + b * Sp, Sp, c);
        const uint64_t canon =
            seekmer::canonical_window(W, seekmer::reverse_bases(W), 0, k);
        khi = (int32_t)(canon >> lo_bits);
        klo = (int32_t)(canon & ((1ull << lo_bits) - 1));
      }
    }
    const int32_t e = seekmer::warp_lookup<G>(v, khi, klo, table, stash,
                                              main_mask, stash_mask);
    if (t < lanes) s_ec[t] = e >= 0 ? e >> aux_bits : -1;
  }
  __syncthreads();

  // a thread a read: its segments' largest sampled EC and whether every
  // hit equals it; the read resolves when every segment does and one hit
  int32_t single_g[2] = {seekmer::SIG_PAD, seekmer::SIG_PAD};
  int need = 0;  // bit g: segment g is re-probed
  const int64_t b = r0 + threadIdx.x;
  if ((int)threadIdx.x < R) {
    int32_t mx[2];
    bool ok[2], any_hit = false, all_ok = true;
    for (int g = 0; g < n_seg; ++g) {
      const int32_t* e = s_ec + (threadIdx.x * n_seg + g) * S;
      int32_t x = -1;
      for (int j = 0; j < S; ++j) x = max(x, e[j]);
      bool one = true;
      for (int j = 0; j < S; ++j) one &= e[j] < 0 || e[j] == x;
      mx[g] = x;
      ok[g] = x < 0 || one;
      any_hit |= x >= 0;
      all_ok &= ok[g];
    }
    const bool resolved = any_hit && all_ok;
    for (int g = 0; g < n_seg; ++g) {
      if (ok[g] && mx[g] >= 0) single_g[g] = mx[g];
      const Mate& m = g ? m1 : m0;
      if (!resolved && (!ok[g] || mx[g] < 0) &&
          has_valid_window(m.bad + b * Sb, min(m.len[b], L), k)) {
        need |= 1 << g;
      }
    }
  }

  // slots: one atomicAdd a warp for its needy units, every lane taking
  // part (threads without a read have none)
  const int lane = threadIdx.x & 31;
  const int cnt = __popc(need);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(seekmer::kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(seekmer::kFull, incl, 31);
  int first = 0;
  if (lane == 31 && total) first = atomicAdd(count, total);
  int next = __shfl_sync(seekmer::kFull, first, 31) + incl - cnt;

  if ((int)threadIdx.x < R) {
    for (int g = 0; g < n_seg; ++g) {
      const int64_t o = b * n_seg + g;
      single[o] = single_g[g];
      if (!((need >> g) & 1)) {
        slot[o] = -1;
        continue;
      }
      const int sl = next++;
      slot[o] = sl;
      const Mate& m = g ? m1 : m0;
      for (int i = 0; i < Sp; ++i) u_packed[(int64_t)sl * Sp + i] = m.packed[b * Sp + i];
      for (int i = 0; i < Sb; ++i) u_bad[(int64_t)sl * Sb + i] = m.bad[b * Sb + i];
      u_len[sl] = m.len[b];
    }
  }
}

template <int G>
int launch(Mate m0, Mate m1, const void* table, const void* stash,
           void* single, void* slot, void* count, void* u_packed, void* u_bad,
           void* u_len, cudaStream_t stream, int64_t B, int n_seg, int L,
           int k, int s, int64_t main_buckets, int64_t stash_buckets,
           int aux_bits) {
  const int P = L - k + 1;
  const int S = (P + s - 1) / s + ((P - 1) % s != 0);  // sampled columns
  const int reads = std::max(1, kThreads / (n_seg * S));
  const size_t smem = sizeof(int32_t) * (size_t)reads * n_seg * S;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  sample_kernel<G><<<seekmer::grid_for(B, reads), kThreads, smem, stream>>>(
      m0, m1, (const int32_t*)table, (const int32_t*)stash, (int32_t*)single,
      (int32_t*)slot, (int32_t*)count, (uint8_t*)u_packed, (uint8_t*)u_bad,
      (int32_t*)u_len, B, n_seg, L, k, s, S, reads,
      (uint32_t)(main_buckets - 1), (uint32_t)(stash_buckets - 1), aux_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seekmer_sample_classify(
    const void* packed0, const void* bad0, const void* len0,
    const void* packed1, const void* bad1, const void* len1,
    const void* table, const void* stash, void* single, void* slot,
    void* count, void* u_packed, void* u_bad, void* u_len, void* stream,
    int64_t device, int64_t B, int64_t n_seg, int64_t L, int64_t k,
    int64_t s, int64_t main_buckets, int64_t stash_buckets, int64_t bucket,
    int64_t aux_bits) {
  cudaSetDevice((int)device);
  if (B <= 0) return (int)cudaGetLastError();
  if (n_seg < 1 || n_seg > 2 || k < 1 || k > 29 || L < k || s < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Mate m0{(const uint8_t*)packed0, (const uint8_t*)bad0,
                (const int32_t*)len0};
  const Mate m1 = n_seg > 1 ? Mate{(const uint8_t*)packed1,
                                   (const uint8_t*)bad1, (const int32_t*)len1}
                            : m0;
  auto st = (cudaStream_t)stream;
#define SEEKMER_SAMPLE(G)                                                    \
  case G:                                                                    \
    return launch<G>(m0, m1, table, stash, single, slot, count, u_packed,    \
                     u_bad, u_len, st, B, (int)n_seg, (int)L, (int)k,        \
                     (int)s, main_buckets, stash_buckets, (int)aux_bits);
  switch (bucket) {
    SEEKMER_SAMPLE(1)
    SEEKMER_SAMPLE(2)
    SEEKMER_SAMPLE(4)
    SEEKMER_SAMPLE(8)
    SEEKMER_SAMPLE(16)
    SEEKMER_SAMPLE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEEKMER_SAMPLE
}
