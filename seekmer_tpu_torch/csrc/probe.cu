// K2: the whole bucketized k-mer lookup, stash included, in one kernel.
//
// Replaces seekmer_tpu/ops/probe_pallas.py `_match_kernel` (called through
// `_bucket_match_pallas`, `make_bucket_lookup`, `lookup_ecs_aux_pallas`)
// and the machinery around it in ops/probe.py `_lookup_flat`. On the TPU
// the hash and the row gather ran in XLA outside the kernel, the gathered
// (N, 128) rows round-tripped device memory, the kernel worked in a
// transposed (128, NC) lane layout with masked-reduction column
// extraction (Mosaic could not slice one lane), and stash keys were
// block-compacted into capped rounds under a while_loop. None of that is
// needed here.
//
// What bounds it on Hopper: random reads of bucket rows from a table far
// larger than L2 (1 GB at GENCODE scale). The first form gave each key a
// warp and four dependent round trips (valid, then hi/lo, then the row's
// hi and lo slabs, then the matched lane's ecaux), so with 64 warps an SM
// it kept ~8,400 keys in flight on the card and was bound by latency, not
// bytes: it cost ~0.2 ns a lane whether the rows came from device memory
// or from L2. This form keeps many keys in flight per warp and reads less:
//
//   - a warp owns 32 consecutive lanes (grid-stride over tiles of 32, the
//     grid sized to the card); lane i loads its valid, hi and lo coalesced
//     and hashes its own key once; invalid lanes write (-1, 0) and load
//     nothing more;
//   - the hi slabs of the warp's 32 home rows are loaded cooperatively in
//     16-byte vectors, G / 4 lanes a row and 128 / G rows a warp
//     instruction (4 rows at G = 32, 32 at G = 4), all issued before any
//     compare, so a warp waits on up to 32 rows at once. Registers hold
//     them (G int32 a lane: 32 at G = 32); a cp.async ring in shared memory
//     would buy nothing here, as the rows are used once and in registers
//     the compare needs no second copy;
//   - the row's hi slab alone decides the 3-state rule of
//     ops/probe.py `_bucket_lookup`: the slots whose hi equals the key's
//     (a bitmask from warp ballots, usually empty or one slot) and whether
//     the row has an empty slot. Only for a hi-matching slot are its lo and
//     ecaux read, two 4-byte loads in one round trip; no lo slab is read,
//     so a found key costs the 128-byte hi slab and two 32-byte sectors;
//   - a valid key that matched nothing in a full row takes the same steps,
//     alone, on its stash row (~2e-4 of keys at load 0.5);
//   - ec and aux are written per lane, coalesced.
//
// Results equal `_lookup_flat` on tables in the slab layout
// (ops/probe.py `device_table_layout`): the matched slot's ecaux if any
// (the largest, should several match), else -1 for a row with an empty
// slot and -2 for a full one, which sends the key to the stash;
// ec = ecaux >> aux_bits (arithmetic shift), aux = ecaux & mask, and
// -1 / 0 for invalid or absent keys.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 4 blocks an SM (<= 64 registers): 32 warps, 1,024 keys in flight an SM
constexpr int kMinBlocks = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = -1;

// How a warp reads the hi slabs of 32 rows of G int32: VEC int32 a load,
// LPR lanes a row, RPI rows a warp instruction, LPR instructions.
template <int G>
struct Geo {
  static constexpr int VEC = G < 4 ? G : 4;
  static constexpr int LPR = G / VEC;
  static constexpr int RPI = 32 / LPR;
};

template <int V>
__device__ __forceinline__ void load_vec(const int32_t* p, int32_t (&v)[V]) {
  if constexpr (V == 4) {
    int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    int2 t = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// Bit i of x (x < 256) moves to bit 4i.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The 3-state value of one row, given the slots whose hi equals the key's
// and whether the row has an empty slot: the largest ecaux of a slot whose
// lo matches too, else -1 (an empty slot) or -2 (full).
template <int G>
__device__ __forceinline__ int32_t resolve(const int32_t* __restrict__ row,
                                           uint32_t match, bool empty,
                                           int32_t klo) {
  int32_t m = empty ? -1 : -2;
  while (match) {  // usually no slot or one
    const int s = __ffs(match) - 1;
    match &= match - 1;
    const int32_t l = __ldg(row + G + s);
    const int32_t e = __ldg(row + 2 * G + s);
    if (l == klo) m = max(m, e);
  }
  return m;
}

// One lane alone on one row (the stash probe): the same steps as the
// warp's cooperative read of the home rows.
template <int G>
__device__ int32_t probe_row(const int32_t* __restrict__ row, int32_t khi,
                             int32_t klo) {
  using C = Geo<G>;
  uint32_t match = 0;
  bool empty = false;
#pragma unroll
  for (int i = 0; i < C::LPR; ++i) {
    int32_t v[C::VEC];
    load_vec<C::VEC>(row + i * C::VEC, v);
#pragma unroll
    for (int c = 0; c < C::VEC; ++c) {
      match |= (uint32_t)(v[c] == khi) << (i * C::VEC + c);
      empty |= v[c] == kEmpty;
    }
  }
  return resolve<G>(row, match, empty, klo);
}

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lookup_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ stash, int32_t* __restrict__ ec_out,
              int32_t* __restrict__ aux_out, int64_t N, uint32_t main_mask,
              uint32_t stash_mask, int aux_bits) {
  using C = Geo<G>;
  const int lane = threadIdx.x & 31;
  const int sub = lane % C::LPR;     // the vector of a row this lane loads
  const int grp = lane / C::LPR;     // the row of an instruction it loads
  const int own_ins = lane / C::RPI; // the instruction loading its own row
  const int own_grp = lane % C::RPI; // and the row's place in it
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t tile = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       tile * 32 < N; tile += warps) {  // uniform across the warp
    const int64_t key = tile * 32 + lane;
    // valid, hi and lo in one round trip: hi and lo are read whether the
    // lane is valid or not (the same lines), so they do not wait on valid
    bool v = false;
    int32_t khi = 0, klo = 0;
    if (key < N) {
      v = valid[key];
      khi = hi[key];
      klo = lo[key];
    }
    long long row = -1;  // home bucket; -1 for lanes that take no part
    if (v) row = seekmer::hash_kmer((uint32_t)khi, (uint32_t)klo) & main_mask;

    // every home row's hi slab, all loads issued before any compare
    int32_t slab[C::LPR][C::VEC];
#pragma unroll
    for (int j = 0; j < C::LPR; ++j) {
      const long long r = __shfl_sync(kFull, row, j * C::RPI + grp);
      if (r >= 0) {
        load_vec<C::VEC>(table + r * 4 * G + sub * C::VEC, slab[j]);
      } else {
#pragma unroll
        for (int c = 0; c < C::VEC; ++c) slab[j][c] = 0;
      }
    }

    // per instruction, ballots of hi matches (one per vector component)
    // and of empty slots; each lane keeps those of its own row
    uint32_t own[C::VEC], own_empty = 0;
#pragma unroll
    for (int c = 0; c < C::VEC; ++c) own[c] = 0;
#pragma unroll
    for (int j = 0; j < C::LPR; ++j) {
      const int32_t kh = __shfl_sync(kFull, khi, j * C::RPI + grp);
      bool e = false;
#pragma unroll
      for (int c = 0; c < C::VEC; ++c) {
        const uint32_t b = __ballot_sync(kFull, slab[j][c] == kh);
        own[c] = j == own_ins ? b : own[c];
        e |= slab[j][c] == kEmpty;
      }
      const uint32_t b = __ballot_sync(kFull, e);
      own_empty = j == own_ins ? b : own_empty;
    }

    int32_t m = -1;
    if (v) {
      // bits [own_grp * LPR, + LPR) of a ballot are this row's vectors;
      // vector i, component c is slot i * VEC + c
      const int shift = own_grp * C::LPR;
      const uint32_t lmask = (1u << C::LPR) - 1;
      uint32_t match = 0;
#pragma unroll
      for (int c = 0; c < C::VEC; ++c) {
        const uint32_t bits = (own[c] >> shift) & lmask;
        match |= (C::VEC == 4 ? spread4(bits) : bits) << c;
      }
      const bool empty = (own_empty >> shift) & lmask;
      m = resolve<G>(table + row * 4 * G, match, empty, klo);
      if (m == -2) {
        const uint32_t sb =
            seekmer::hash_kmer_stash((uint32_t)khi, (uint32_t)klo) &
            stash_mask;
        m = probe_row<G>(stash + (int64_t)sb * 4 * G, khi, klo);
      }
    }
    if (key < N) {
      ec_out[key] = m >= 0 ? m >> aux_bits : -1;
      aux_out[key] = m >= 0 ? m & ((1 << aux_bits) - 1) : 0;
    }
  }
}

template <int G>
int launch(const void* hi, const void* lo, const void* valid,
           const void* table, const void* stash, void* ec, void* aux,
           cudaStream_t stream, int device, int64_t N, int64_t main_buckets,
           int64_t stash_buckets, int aux_bits) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lookup_kernel<G>,
                                                kThreads, 0);
  const int64_t need = seekmer::grid_for(N, kThreads);
  const int grid =
      (int)std::max<int64_t>(1, std::min<int64_t>(need, (int64_t)sms * per_sm));
  lookup_kernel<G><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid,
      (const int32_t*)table, (const int32_t*)stash, (int32_t*)ec,
      (int32_t*)aux, N, (uint32_t)(main_buckets - 1),
      (uint32_t)(stash_buckets - 1), aux_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seekmer_lookup(const void* hi, const void* lo,
                              const void* valid, const void* table,
                              const void* stash, void* ec, void* aux,
                              void* stream, int64_t device, int64_t N,
                              int64_t main_buckets, int64_t stash_buckets,
                              int64_t bucket, int64_t aux_bits) {
  cudaSetDevice((int)device);
  if (N <= 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  const int d = (int)device, ab = (int)aux_bits;
  switch (bucket) {
    case 1: return launch<1>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    case 2: return launch<2>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    case 4: return launch<4>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    case 8: return launch<8>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    case 16: return launch<16>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    case 32: return launch<32>(hi, lo, valid, table, stash, ec, aux, s, d, N, main_buckets, stash_buckets, ab);
    default: return (int)cudaErrorInvalidValue;
  }
}
