// I1: lay the bucketized k-mer table out in place, as the lookups read it.
//
// Replaces no TPU kernel: the JAX package lays the table out on the host
// (seekmer_tpu/ops/probe.py `device_table_layout`) and uploads the result,
// and the port did the same, several numpy passes over the ~1 GB table in
// every Mapper build. Here the raw table is uploaded as it is and laid out
// on the card. A bucket row of G slots [hi, lo, ec, aux] (16 bytes a slot)
// becomes, in the same 16 G bytes, [hi x G | lo x G | ecaux x G | meta x G]:
// ecaux = ec << aux_bits | clip(aux, 0, 2^aux_bits - 1) for occupied slots
// (hi != -1) and -1 for empty ones, meta the bucket-full flag broadcast
// over the row. The largest EC id of the occupied slots goes into one int
// (atomicMax, once a block), which the wrapper reads back to check it
// against the packed lane's limit.
//
// What bounds it on Hopper: the bytes, one read and one write of the table
// (2 x 1.07 GB / 3.35 TB/s = 0.64 ms at GENCODE scale). A group of G lanes
// takes a bucket, a warp 32 / G of them (one bucket at G = 32): each lane
// loads its slot as one int4, so a warp's 32 slots, 512 contiguous bytes,
// arrive in one coalesced load, and at G = 32 each of the four stores (hi,
// lo, ecaux, meta) is one coalesced 128-byte line. The group's vote on
// hi != -1 gives meta. A warp issues the loads of kUnroll such 512-byte
// units before it stores any, enough bytes in flight to keep HBM busy. Each
// unit is whole in the warp's registers before any of its stores (the vote
// needs every lane's load), and units are disjoint, so the rewrite in place
// is safe and the layout needs no second buffer on the card.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 512-byte units a warp has in flight
constexpr int32_t kEmpty = -1;

template <int G>
__global__ void __launch_bounds__(kThreads)
layout_kernel(int32_t* rows, int32_t* ec_max, int64_t n_slots,
              int aux_bits) {
  // rows is read and rewritten in place: no __restrict__, no __ldg
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int j = lane & (G - 1);  // the lane's slot in its bucket
  const uint32_t group =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int32_t aux_mask = (1 << aux_bits) - 1;
  const int64_t n_units = (n_slots + 31) / 32;
  int32_t m = INT_MIN;
  for (int64_t u0 = ((int64_t)blockIdx.x * kWarps + warp) * kUnroll;
       u0 < n_units;  // uniform across the warp
       u0 += (int64_t)gridDim.x * kWarps * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t s = (u0 + i) * 32 + lane;
      // whole buckets lie past n_slots (a multiple of G): read as empty
      v[i] = s < n_slots ? reinterpret_cast<const int4*>(rows)[s]
                         : make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t s = (u0 + i) * 32 + lane;
      const bool occ = v[i].x != kEmpty;
      const int32_t full =
          (__ballot_sync(0xFFFFFFFFu, occ) & group) == group;
      if (s < n_slots) {
        if (occ) m = max(m, v[i].z);
        const int32_t aux = min(max(v[i].w, 0), aux_mask);
        int32_t* row = rows + (s - j) * 4;
        row[j] = v[i].x;
        row[G + j] = v[i].y;
        row[2 * G + j] =
            occ ? (int32_t)(((uint32_t)v[i].z << aux_bits) | (uint32_t)aux)
                : kEmpty;
        row[3 * G + j] = full;
      }
    }
  }
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  __shared__ int32_t s_max[kWarps];
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, s_max[w]);
    if (m != INT_MIN) atomicMax(ec_max, m);
  }
}

template <int G>
int launch(void* rows, void* ec_max, cudaStream_t stream, int device,
           int64_t n_slots, int aux_bits) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layout_kernel<G>,
                                                kThreads, 0);
  const int64_t need = seekmer::grid_for((n_slots + 31) / 32,
                                         (int64_t)kWarps * kUnroll);
  const unsigned int grid = (unsigned int)std::max<int64_t>(
      1, std::min<int64_t>(need, (int64_t)sms * per_sm));
  layout_kernel<G><<<grid, kThreads, 0, stream>>>(
      (int32_t*)rows, (int32_t*)ec_max, n_slots, aux_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: int32[n_slots, 4], laid out in place as int32[n_slots / G, 4 G];
// ec_max: one int32, raised to the largest EC id of an occupied slot.
extern "C" int seekmer_layout(void* rows, void* ec_max, void* stream,
                              int64_t device, int64_t n_slots, int64_t bucket,
                              int64_t aux_bits) {
  cudaSetDevice((int)device);
  if (n_slots <= 0) return (int)cudaGetLastError();
  if (bucket < 1 || n_slots % bucket) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const int d = (int)device, ab = (int)aux_bits;
  switch (bucket) {
    case 1: return launch<1>(rows, ec_max, s, d, n_slots, ab);
    case 2: return launch<2>(rows, ec_max, s, d, n_slots, ab);
    case 4: return launch<4>(rows, ec_max, s, d, n_slots, ab);
    case 8: return launch<8>(rows, ec_max, s, d, n_slots, ab);
    case 16: return launch<16>(rows, ec_max, s, d, n_slots, ab);
    case 32: return launch<32>(rows, ec_max, s, d, n_slots, ab);
    default: return (int)cudaErrorInvalidValue;
  }
}
