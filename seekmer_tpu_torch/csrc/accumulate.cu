// A1: fold one batch of read signatures into the signature count table.
//
// Counterpart of seekmer_tpu/map/signature.py `accumulate` and
// `accumulate_direct`, which the JAX package ran in XLA (no Pallas kernel):
// a scatter-then-regather compare-and-swap inside a while_loop, one probe
// round per loop iteration, with the count scatter-add, the winners' row
// scatter and the collision audit after the loop. In eager PyTorch that
// loop would sync with the host every round, and a duplicate-index write
// of the two int32 fingerprint halves can tear on the GPU (each half from
// a different lane, so the slot holds a key nobody owns). Here:
//
//  * claim kernel, one thread per read: single-EC rows (sig[1] == SIG_PAD)
//    go to the exact per-EC vector with atomicAdd (the `accumulate_direct`
//    path); multi-EC rows fingerprint their row (the 64-bit
//    sig_fingerprint of map/signature.py `fingerprint`), then walk at most
//    `sig_probe` KB-slot key buckets from the home bucket. The key table is
//    read as uint64 (a view of the same int32[..., KB, 2] storage), so a
//    claim is one 64-bit atomicCAS on an empty (0) slot and can never
//    tear. A slot holding the lane's own fingerprint, or a lost CAS that
//    returns it, is a match. The winner of a claim writes the signature
//    row; every resolved lane atomicAdds its weight into count. A lane that
//    exhausts its buckets adds its weight to `overflow`.
//  * audit kernel, a separate launch: each resolved lane compares its row
//    with the stored row of its slot and adds its weight to `collisions`
//    on a mismatch. Inside the claim launch a matcher could read the row
//    before its winner wrote it and report a false collision.
//
// Budget: JAX spends one of its `sig_probe` rounds per bucket visited and
// per lost claim retried; here only buckets count (a lost CAS moves on to
// the next slot of the same bucket at no cost). The overflow counts agree
// whenever no lane exhausts its budget. Slot placement under concurrent
// claims differs from JAX, so results are compared after the host merge.
//
// What bounds it on Hopper: atomics and the random 64-byte key-bucket read
// per multi-EC read; single-EC reads (the majority) cost one atomicAdd.

#include "common.cuh"

namespace {

constexpr int KB = 8;  // slots per key bucket, map/signature.py KB

__device__ __forceinline__ int read_weight(const uint8_t* mapped,
                                           const int32_t* weights, int64_t b) {
  if (!mapped[b]) return 0;
  return weights ? weights[b] : 1;
}

__global__ void claim_kernel(const int32_t* __restrict__ sig,
                             const uint8_t* __restrict__ mapped,
                             const int32_t* __restrict__ weights,
                             unsigned long long* key, int32_t* count,
                             int32_t* sigtab, int32_t* ec_count,
                             int32_t* overflow, int32_t* res_slot, int64_t B,
                             int C, int64_t n_key_buckets, int64_t ec_len,
                             int sig_probe) {
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  res_slot[b] = -1;
  const int w = read_weight(mapped, weights, b);
  if (w <= 0) return;
  const int32_t* row = sig + b * C;
  const bool single = row[0] != seekmer::SIG_PAD &&
                      (C == 1 || row[1] == seekmer::SIG_PAD);
  if (ec_len > 1 && single) {  // exact per-EC vector; last slot is the dump
    if (row[0] >= 0 && row[0] < ec_len - 1) atomicAdd(&ec_count[row[0]], w);
    return;
  }
  uint32_t h1 = 0x2545F491u, h2 = 0x8F1BBCDCu;
  for (int c = 0; c < C; ++c) {
    seekmer::sig_fingerprint_step(h1, h2, (uint32_t)row[c]);
  }
  if (h1 == 0 && h2 == 0) h1 = 1;  // (0, 0) marks an empty slot
  const unsigned long long fp =
      (unsigned long long)h1 | ((unsigned long long)h2 << 32);
  int64_t cursor =
      seekmer::sig_slot_hash(h1, h2) & (uint32_t)(n_key_buckets - 1);
  int64_t slot = -1;
  bool won = false;
  for (int r = 0; r < sig_probe && slot < 0; ++r) {
    unsigned long long* bk = key + cursor * KB;
    for (int j = 0; j < KB; ++j) {
      unsigned long long cur = bk[j];
      if (cur == 0ull) cur = atomicCAS(bk + j, 0ull, fp);
      won = cur == 0ull;  // the CAS above claimed the empty slot
      if (won || cur == fp) {
        slot = cursor * KB + j;
        break;
      }
    }
    cursor = (cursor + 1) & (n_key_buckets - 1);
  }
  if (slot < 0) {
    atomicAdd(overflow, w);
    return;
  }
  atomicAdd(&count[slot], w);
  if (won) {
    for (int c = 0; c < C; ++c) sigtab[slot * C + c] = row[c];
  }
  res_slot[b] = (int32_t)slot;
}

__global__ void audit_kernel(const int32_t* __restrict__ sig,
                             const uint8_t* __restrict__ mapped,
                             const int32_t* __restrict__ weights,
                             const int32_t* __restrict__ res_slot,
                             const int32_t* __restrict__ sigtab,
                             int32_t* collisions, int64_t B, int C) {
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t slot = res_slot[b];
  if (slot < 0) return;
  const int32_t* row = sig + b * C;
  const int32_t* stored = sigtab + slot * C;
  bool differ = false;
  for (int c = 0; c < C; ++c) differ |= stored[c] != row[c];
  if (differ) atomicAdd(collisions, read_weight(mapped, weights, b));
}

}  // namespace

extern "C" int seekmer_accumulate(const void* sig, const void* mapped,
                                  const void* weights, void* key, void* count,
                                  void* sigtab, void* ec_count,
                                  void* overflow, void* collisions,
                                  void* res_slot, void* stream, int64_t device,
                                  int64_t B, int64_t C, int64_t n_key_buckets,
                                  int64_t ec_len, int64_t sig_probe,
                                  int64_t audit) {
  cudaSetDevice((int)device);
  if (B > 0) {
    const int threads = 256;
    cudaStream_t st = (cudaStream_t)stream;
    claim_kernel<<<seekmer::grid_for(B, threads), threads, 0, st>>>(
        (const int32_t*)sig, (const uint8_t*)mapped, (const int32_t*)weights,
        (unsigned long long*)key, (int32_t*)count, (int32_t*)sigtab,
        (int32_t*)ec_count, (int32_t*)overflow, (int32_t*)res_slot, B, (int)C,
        n_key_buckets, ec_len, (int)sig_probe);
    if (audit) {
      audit_kernel<<<seekmer::grid_for(B, threads), threads, 0, st>>>(
          (const int32_t*)sig, (const uint8_t*)mapped,
          (const int32_t*)weights, (const int32_t*)res_slot,
          (const int32_t*)sigtab, (int32_t*)collisions, B, (int)C);
    }
  }
  return (int)cudaGetLastError();
}
