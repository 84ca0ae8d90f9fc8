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
// them); the 2-bit rows it reads are ~0.4 bytes a base. A lookup round of
// `seekmer::warp_lookup` keeps one row in flight for each of its 32
// lanes, so what the kernel controls is how full its rounds are and what
// stands between them. Its design:
//
//   - a warp owns a tile of whole reads (the plan, ops/fast_cuda.py
//     `sample_plan`: at most 32 segments, at most `keys` sampled lanes,
//     16 pairs at config 2, s = 16) and walks the batch grid-stride; no
//     block barrier anywhere, every warp looks up and classifies;
//   - its reads' 2-bit rows and bad bitmasks are read once, as 16-byte
//     vectors of the contiguous span the tile's rows make, into the warp's
//     own slice of shared memory (`__syncwarp` only); a segment's lane
//     reads its length. A lane's
//     window lies in a row whose words a register layout would spread over
//     other lanes at any L, so the rows sit where every lane can read any
//     8 bytes of them: two 8-byte loads and a funnel shift give a
//     sampled window's bases and bad bits, then kmer.cuh's closed form;
//   - only valid sampled keys enter the lookup rounds: each 32 sampled
//     lanes ballot their validity and write their keys at their ranks (a
//     prefix count by `__popc`), so the rounds that follow are full but
//     the last; each round's results overwrite their keys in place;
//   - then a lane a segment reduces its keys' ECs (they sit at ranks that
//     the ballots' prefix counts give): its largest, whether every hit
//     equals it, whether any hit. A read resolves by a shuffle with its
//     mate's lane;
//   - a segment that must be re-probed checks in closed form that its row
//     has k good bases in a row within its length: good = ~bad & first
//     `len` bits, 64 bits a step, a run of k found by ceil(log2 k)
//     shift-and doublings, a run across words by the word's trailing good
//     bases added to the run carried from the word before;
//   - needy units take slots through one atomicAdd a tile on the device
//     counter; their slots are consecutive, so the warp writes their rows
//     as one contiguous span of vectors. Their order is not deterministic;
//     nothing downstream depends on it (the merge reads a unit through
//     its slot).
//
// Sampled columns are static over the padded width: 0, s, 2s, ... below
// P = L - k + 1, then P - 1 (ops/probe.py `sample_columns`).

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "kmer.cuh"
#include "lookup.cuh"

namespace {

constexpr int kMaxWarps = 8;   // warps a block; the plan may take fewer
constexpr int kMinBlocks = 4;  // <= 64 registers, as K2

struct Mate {
  const uint8_t* packed;  // [B, (L + 3) / 4]
  const uint8_t* bad;     // [B, (L + 7) / 8]
  const int32_t* len;     // [B]
};

// Bytes a staged row span of n bytes needs: `stage` copies it from the
// 16-byte chunk holding its first byte, and `bytes8` reads 16 bytes from
// an 8-byte word at or before its last.
inline int span_bytes(int n) { return ((n + 30) & ~15) + 16; }

// The carve of a warp's shared memory, in bytes from its start, as
// ops/fast_cuda.py `sample_plan` lays it out: mate g's packed span at
// g * mate, its bad span at g * mate + bad, then the keys (hi, lo), the
// validity ballots (a word each 32 sampled lanes) and the needy segments
// (32 bytes). The launcher checks that each part fits its place.
struct Carve {
  int bad, mate, keys, bits, useg;
};

// Where byte off of a global row span lands in its staged copy: its
// place in its 16-byte chunk.
__device__ __forceinline__ int landed(const uint8_t* src, int64_t off) {
  return (int)((uintptr_t)(src + off) & 15);
}

// Copies bytes [off, off + n) of a global row span into shared memory from
// the 16-byte chunk that holds byte off, in 16-byte vectors (a chunk that
// holds a byte of the span lies in a mapped page).
__device__ __forceinline__ void stage(const uint8_t* src, int64_t off, int n,
                                      uint8_t* dst, int lane) {
  const uintptr_t a = (uintptr_t)(src + off);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int chunks = (int)((a + n - a0 + 15) >> 4);
  for (int t = lane; t < chunks; t += 32) {
    reinterpret_cast<int4*>(dst)[t] =
        __ldg(reinterpret_cast<const int4*>(a0) + t);
  }
}

// The 8 bytes of a shared span from byte off, little-endian.
__device__ __forceinline__ uint64_t bytes8(const uint8_t* s, int off) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(s) + (off >> 3);
  const int sh = (off & 7) * 8;
  const uint64_t lo = w[0], hi = w[1];
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

// Whether the first n bases of a bad-bitmask row (from byte off of s)
// hold k consecutive good bases: 64 bases a step, a run of k inside the
// word by doubling shift-ands, one across words by the carried run.
__device__ bool has_window(const uint8_t* s, int off, int n, int k) {
  int carry = 0;
  for (int w = 0; 64 * w < n; ++w) {
    uint64_t good = ~bytes8(s, off + 8 * w);
    if (n - 64 * w < 64) good &= (1ull << (n - 64 * w)) - 1;
    const bool full = good == ~0ull;
    const int trail = full ? 64 : __ffsll((long long)~good) - 1;
    if (carry + trail >= k) return true;
    uint64_t r = good;
    for (int span = 1; span < k;) {
      const int sh = min(span, k - span);
      r &= r >> sh;
      span += sh;
    }
    if (r) return true;
    carry = full ? carry + 64 : __clzll((long long)~good);
  }
  return false;
}

// Valid sampled lanes before position pos of the tile's lane space.
__device__ __forceinline__ int valid_before(const uint32_t* bits, int pos) {
  int n = 0;
  for (int j = 0; j < pos >> 5; ++j) n += __popc(bits[j]);
  if (pos & 31) n += __popc(bits[pos >> 5] & ((1u << (pos & 31)) - 1));
  return n;
}

// Rows of the tile's needy units, from shared memory to their slots: unit
// i (slot first + i) is segment useg[i]; w bytes a row, in vectors of the
// largest of 8, 4, 2, 1 bytes that divides w (so every store is aligned).
__device__ __forceinline__ void copy_rows(uint8_t* __restrict__ dst, int w,
                                          int n, const uint8_t* useg,
                                          const uint8_t* smem, int mate_bytes,
                                          int pre0, int pre1, int n_seg,
                                          int lane) {
  const int V = (w & 7) == 0 ? 8 : (w & 3) == 0 ? 4 : (w & 1) == 0 ? 2 : 1;
  const int per = w / V;
  for (int t = lane; t < n * per; t += 32) {
    const int i = t / per, o = (t - i * per) * V;
    const int sg = useg[i], r = sg / n_seg, g = sg - r * n_seg;
    const uint64_t v =
        bytes8(smem + g * mate_bytes, (g ? pre1 : pre0) + r * w + o);
    uint8_t* d = dst + (int64_t)i * w + o;
    if (V == 8) {
      *reinterpret_cast<uint64_t*>(d) = v;
    } else if (V == 4) {
      *reinterpret_cast<uint32_t*>(d) = (uint32_t)v;
    } else if (V == 2) {
      *reinterpret_cast<uint16_t*>(d) = (uint16_t)v;
    } else {
      *d = (uint8_t)v;
    }
  }
}

struct Params {
  int64_t B;
  int n_seg, L, k, s, S, reads, n_keys, warp_bytes;
  Carve cv;
  uint32_t main_mask, stash_mask;
  int aux_bits;
};

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
sample_kernel(Mate m0, Mate m1, const int32_t* __restrict__ table,
              const int32_t* __restrict__ stash, int32_t* __restrict__ single,
              int32_t* __restrict__ slot, int32_t* __restrict__ count,
              uint8_t* __restrict__ u_packed, uint8_t* __restrict__ u_bad,
              int32_t* __restrict__ u_len, Params p) {
  extern __shared__ __align__(16) uint8_t smem_all[];
  const int lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1;
  const int n_seg = p.n_seg, S = p.S, k = p.k;
  const int Sp = (p.L + 3) >> 2, Sb = (p.L + 7) >> 3, P = p.L - k + 1;
  const Carve cv = p.cv;
  uint8_t* smem = smem_all + (threadIdx.x >> 5) * p.warp_bytes;
  // key i: hi at keys[2 i], lo at keys[2 i + 1]; its EC replaces its hi
  int32_t* keys = reinterpret_cast<int32_t*>(smem + cv.keys);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + cv.bits);
  uint8_t* useg = smem + cv.useg;
  const int lo_bits = 2 * (k - k / 2);
  const uint32_t maskk = (1u << k) - 1;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);

  for (int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
       tile * p.reads < p.B; tile += warps) {  // uniform across the warp
    const int64_t b0 = tile * p.reads;
    const int R = (int)min((long long)p.reads, (long long)(p.B - b0));
    const int nseg = R * n_seg, lanes = nseg * S;

    // the tile's rows, once, as 16-byte vectors; a segment's lane holds
    // its length
    stage(m0.packed, b0 * Sp, R * Sp, smem, lane);
    stage(m0.bad, b0 * Sb, R * Sb, smem + cv.bad, lane);
    if (n_seg == 2) {
      stage(m1.packed, b0 * Sp, R * Sp, smem + cv.mate, lane);
      stage(m1.bad, b0 * Sb, R * Sb, smem + cv.mate + cv.bad, lane);
    }
    int len_raw = 0;
    if (lane < nseg) {
      const int r = lane / n_seg;
      len_raw = (lane - r * n_seg ? m1.len : m0.len)[b0 + r];
    }
    const int len = max(0, min(len_raw, p.L));
    __syncwarp();

    // sampled lanes, 32 a step: valid keys go to their ranks
    int nvalid = 0;
    for (int j = 0; 32 * j < lanes; ++j) {
      const int q = 32 * j + lane;
      const int sg = min(q / S, nseg - 1);
      const int ln = __shfl_sync(seekmer::kFull, len, sg);
      bool v = false;
      int32_t khi = 0, klo = 0;
      if (q < lanes) {
        const int c = min((q - sg * S) * p.s, P - 1);
        const int r = sg / n_seg, g = sg - r * n_seg;
        const uint8_t* mate = smem + g * cv.mate;
        if (c + k <= ln &&
            ((uint32_t)(bytes8(mate + cv.bad,
                               landed(g ? m1.bad : m0.bad, b0 * Sb) + r * Sb +
                                   (c >> 3)) >>
                        (c & 7)) &
             maskk) == 0) {
          v = true;
          const uint64_t W =
              bytes8(mate,
                     landed(g ? m1.packed : m0.packed, b0 * Sp) + r * Sp +
                         (c >> 2)) >>
              (2 * (c & 3));
          const uint64_t canon =
              seekmer::canonical_window(W, seekmer::reverse_bases(W), 0, k);
          khi = (int32_t)(canon >> lo_bits);
          klo = (int32_t)(canon & ((1ull << lo_bits) - 1));
        }
      }
      const uint32_t bal = __ballot_sync(seekmer::kFull, v);
      if (v) {
        const int i = nvalid + __popc(bal & lt);
        keys[2 * i] = khi;
        keys[2 * i + 1] = klo;
      }
      if (lane == 0) bits[j] = bal;
      nvalid += __popc(bal);
    }
    __syncwarp();

    // full lookup rounds of valid keys; each result replaces its key
    for (int base = 0; base < nvalid; base += 32) {
      const int i = base + lane;
      const bool v = i < nvalid;
      const int32_t e = seekmer::warp_lookup<G>(
          v, v ? keys[2 * i] : 0, v ? keys[2 * i + 1] : 0, table, stash,
          p.main_mask, p.stash_mask);
      if (v) keys[2 * i] = e >= 0 ? e >> p.aux_bits : -1;
    }
    __syncwarp();

    // a lane a segment: its largest sampled EC, whether every hit equals
    // it; the read resolves when each of its segments is ok and one hit
    int32_t mx = -1, mn = INT_MAX;
    if (lane < nseg) {
      const int end = valid_before(bits, (lane + 1) * S);
      for (int i = valid_before(bits, lane * S); i < end; ++i) {
        const int32_t x = keys[2 * i];
        if (x >= 0) mx = max(mx, x), mn = min(mn, x);
      }
    }
    const bool ok = mx < 0 || mn == mx;
    bool any_hit = mx >= 0, all_ok = ok;
    if (n_seg == 2) {
      any_hit |= __shfl_xor_sync(seekmer::kFull, any_hit, 1);
      all_ok &= __shfl_xor_sync(seekmer::kFull, all_ok, 1);
    }
    const bool resolved = any_hit && all_ok;
    bool need = false;
    if (lane < nseg && !resolved && (!ok || mx < 0)) {
      const int r = lane / n_seg, g = lane - r * n_seg;
      need = has_window(smem + g * cv.mate + cv.bad,
                        landed(g ? m1.bad : m0.bad, b0 * Sb) + r * Sb, len,
                        k);
    }

    // slots: one atomicAdd a tile; its units' slots are consecutive
    const uint32_t needy = __ballot_sync(seekmer::kFull, need);
    const int n_units = __popc(needy);
    int first = 0;
    if (lane == 0 && n_units) first = atomicAdd(count, n_units);
    first = __shfl_sync(seekmer::kFull, first, 0);
    if (lane < nseg) {
      const int64_t o = b0 * n_seg + lane;
      single[o] = ok && mx >= 0 ? mx : seekmer::SIG_PAD;
      const int rank = __popc(needy & lt);
      slot[o] = need ? first + rank : -1;
      if (need) {
        u_len[first + rank] = len_raw;
        useg[rank] = (uint8_t)lane;
      }
    }
    __syncwarp();
    if (n_units) {
      copy_rows(u_packed + (int64_t)first * Sp, Sp, n_units, useg,
                smem, cv.mate, landed(m0.packed, b0 * Sp),
                landed(m1.packed, b0 * Sp), n_seg, lane);
      copy_rows(u_bad + (int64_t)first * Sb, Sb, n_units, useg,
                smem + cv.bad, cv.mate, landed(m0.bad, b0 * Sb),
                landed(m1.bad, b0 * Sb), n_seg, lane);
    }
    __syncwarp();  // the next tile overwrites the rows
  }
}

template <int G>
int launch(Mate m0, Mate m1, const void* table, const void* stash,
           void* single, void* slot, void* count, void* u_packed, void* u_bad,
           void* u_len, cudaStream_t stream, int device, const Params& p,
           int warps) {
  const size_t smem = (size_t)warps * p.warp_bytes;
  auto kernel = sample_kernel<G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                smem);
  const int64_t tiles = (p.B + p.reads - 1) / p.reads;
  const int grid = (int)std::max<int64_t>(
      1, std::min<int64_t>(seekmer::grid_for(tiles, warps),
                           (int64_t)sms * std::max(per_sm, 1)));
  kernel<<<grid, warps * 32, smem, stream>>>(
      m0, m1, (const int32_t*)table, (const int32_t*)stash, (int32_t*)single,
      (int32_t*)slot, (int32_t*)count, (uint8_t*)u_packed, (uint8_t*)u_bad,
      (int32_t*)u_len, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (S, reads, keys, warp_bytes, warps and the carve's offsets) is
// ops/fast_cuda.py `sample_plan`'s; it is checked here to hold every
// sampled lane and to give each part of the carve the bytes it needs.
extern "C" int seekmer_sample_classify(
    const void* packed0, const void* bad0, const void* len0,
    const void* packed1, const void* bad1, const void* len1,
    const void* table, const void* stash, void* single, void* slot,
    void* count, void* u_packed, void* u_bad, void* u_len, void* stream,
    int64_t device, int64_t B, int64_t n_seg, int64_t L, int64_t k,
    int64_t s, int64_t main_buckets, int64_t stash_buckets, int64_t bucket,
    int64_t aux_bits, int64_t S, int64_t reads, int64_t n_keys,
    int64_t warp_bytes, int64_t warps, int64_t bad_at, int64_t mate_at,
    int64_t keys_at, int64_t bits_at, int64_t useg_at) {
  cudaSetDevice((int)device);
  if (B <= 0) return (int)cudaGetLastError();
  const int64_t P = L - k + 1;
  if (n_seg < 1 || n_seg > 2 || k < 1 || k > 29 || L < k || s < 2 ||
      S != (P + s - 1) / s + ((P - 1) % s != 0) || reads < 1 ||
      reads * n_seg > 32 || reads * n_seg * S > n_keys || n_keys % 32 ||
      warps < 1 || warps > kMaxWarps || warp_bytes % 16 || bad_at % 16 ||
      mate_at % 16 || keys_at % 8 || bits_at % 4 ||
      bad_at < span_bytes((int)(reads * ((L + 3) / 4))) ||
      mate_at - bad_at < span_bytes((int)(reads * ((L + 7) / 8))) ||
      keys_at < n_seg * mate_at || bits_at - keys_at < 8 * n_keys ||
      useg_at - bits_at < n_keys / 8 || warp_bytes - useg_at < 32) {
    return (int)cudaErrorInvalidValue;
  }
  const Mate m0{(const uint8_t*)packed0, (const uint8_t*)bad0,
                (const int32_t*)len0};
  const Mate m1 = n_seg > 1 ? Mate{(const uint8_t*)packed1,
                                   (const uint8_t*)bad1, (const int32_t*)len1}
                            : m0;
  const Params p{B, (int)n_seg, (int)L, (int)k, (int)s, (int)S, (int)reads,
                 (int)n_keys, (int)warp_bytes,
                 Carve{(int)bad_at, (int)mate_at, (int)keys_at, (int)bits_at,
                       (int)useg_at},
                 (uint32_t)(main_buckets - 1), (uint32_t)(stash_buckets - 1),
                 (int)aux_bits};
  auto st = (cudaStream_t)stream;
  const int d = (int)device, w = (int)warps;
#define SEEKMER_SAMPLE(G)                                                    \
  case G:                                                                    \
    return launch<G>(m0, m1, table, stash, single, slot, count, u_packed,    \
                     u_bad, u_len, st, d, p, w);
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
