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
// The warp's steps are `seekmer::warp_lookup` in lookup.cuh, which K5
// (sample.cu) shares. Results equal `_lookup_flat` on tables in the slab layout
// (ops/probe.py `device_table_layout`): the matched slot's ecaux if any
// (the largest, should several match), else -1 for a row with an empty
// slot and -2 for a full one, which sends the key to the stash;
// ec = ecaux >> aux_bits (arithmetic shift), aux = ecaux & mask, and
// -1 / 0 for invalid or absent keys.

#include <algorithm>

#include "lookup.cuh"

namespace {

constexpr int kThreads = 256;
// 4 blocks an SM (<= 64 registers): 32 warps, 1,024 keys in flight an SM
constexpr int kMinBlocks = 4;

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lookup_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ stash, int32_t* __restrict__ ec_out,
              int32_t* __restrict__ aux_out, int64_t N, uint32_t main_mask,
              uint32_t stash_mask, int aux_bits) {
  const int lane = threadIdx.x & 31;
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
    const int32_t m = seekmer::warp_lookup<G>(v, khi, klo, table, stash,
                                              main_mask, stash_mask);
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
