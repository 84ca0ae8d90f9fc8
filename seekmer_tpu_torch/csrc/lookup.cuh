// The warp-cooperative bucket lookup of K2 (probe.cu), shared with K5
// (sample.cu), which looks up fast mode's sampled windows with it.
//
// Tables are in the slab layout of ops/probe.py `device_table_layout`: a
// bucket row is [hi x G | lo x G | ecaux x G | meta x G] int32. A warp
// looks up 32 keys, one a lane: the hi slabs of their 32 home rows are
// loaded cooperatively in 16-byte vectors, G / 4 lanes a row and 128 / G
// rows a warp instruction, all issued before any compare; the row's hi
// slab alone decides which slots match the key's hi and whether the row
// has an empty slot, and only a hi-matching slot's lo and ecaux are read.
// A valid key absent from a full row probes its stash row alone. The
// result is the 3-state rule of ops/probe.py `_bucket_lookup`: the
// matched slot's ecaux (the largest, should several match), else -1 (an
// empty slot: absent) or -2 (full, and absent from the stash too).
#pragma once

#include "common.cuh"

namespace seekmer {

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

// The lookup of one key a lane of a warp, `v` false for a lane without a
// key. Every lane of the warp must call it together (it shuffles and
// ballots over the whole warp). Returns the lane's 3-state value; -1 for a
// lane without a key.
template <int G>
__device__ __forceinline__ int32_t warp_lookup(
    bool v, int32_t khi, int32_t klo, const int32_t* __restrict__ table,
    const int32_t* __restrict__ stash, uint32_t main_mask,
    uint32_t stash_mask) {
  using C = Geo<G>;
  const int lane = threadIdx.x & 31;
  const int sub = lane % C::LPR;     // the vector of a row this lane loads
  const int grp = lane / C::LPR;     // the row of an instruction it loads
  const int own_ins = lane / C::RPI; // the instruction loading its own row
  const int own_grp = lane % C::RPI; // and the row's place in it
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
  return m;
}

}  // namespace seekmer
