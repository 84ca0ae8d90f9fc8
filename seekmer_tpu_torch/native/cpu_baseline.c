/* Single-core compiled CPU pseudoalignment baseline: the port's copy of
 * seekmer_tpu/native/cpu_baseline.c, with the same plain C interface
 * (seekmer_cpu_build, seekmer_cpu_free, seekmer_cpu_map) and the same
 * per-read semantics, so the same index and codes give the same signature
 * tables element for element (tests/test_torch_cpu_baseline.py).
 *
 * It is the yardstick of the project's throughput target, >= 10x a single
 * CPU core running the reference's algorithm class (BASELINE.json:5): a
 * compiled rolling-k-mer hash-probe loop, single-threaded, as the
 * reference's Cython mapper kernel is. Per read: roll the canonical
 * k-mers, probe an open-addressing k-mer -> EC table at every valid window
 * (or, with use_skip, jump by the hit's EC run length), reduce to the
 * sorted distinct EC signature, and count per distinct signature in a
 * table keyed by a 64-bit fingerprint. A read with more than max_ecs
 * distinct ECs ("complex", unmapped) stops probing early, which only makes
 * the baseline faster than the exact rule.
 *
 * One fault of the copied source is repaired: it clamped max_ecs to 64
 * without a word, so above 64 it called reads complex that the mapper
 * maps. Here max_ecs > 64 is refused (seekmer_cpu_map returns -2).
 *
 * Host code, not a kernel: built with the system C compiler at first use
 * (cc -O3 -shared -fPIC, seekmer_tpu_torch/native/cpu_baseline.py) and
 * bound with ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EMPTY_KEY (~0ULL) /* canonical k-mers use <= 58 bits; ~0 is free */
#define MAX_ECS 64        /* the per-read EC set's capacity */

typedef struct {
  uint64_t *keys;
  int32_t *ecs;
  uint8_t *aux; /* per-key EC run length (skip distance), 0 if unknown */
  uint64_t mask; /* table_size - 1, power of two */
  int k;
} cpu_index;

static inline uint64_t mix64(uint64_t x) { /* splitmix64 finalizer */
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

void *seekmer_cpu_build(const uint64_t *keys, const int32_t *ecs,
                        const uint8_t *aux, long n, int k) {
  long size = 64;
  while (size < 2 * n) size <<= 1; /* load <= 0.5 */
  cpu_index *ix = (cpu_index *)malloc(sizeof *ix);
  if (!ix) return NULL;
  ix->keys = (uint64_t *)malloc((size_t)size * 8);
  ix->ecs = (int32_t *)malloc((size_t)size * 4);
  ix->aux = (uint8_t *)calloc((size_t)size, 1);
  if (!ix->keys || !ix->ecs || !ix->aux) {
    free(ix->keys);
    free(ix->ecs);
    free(ix->aux);
    free(ix);
    return NULL;
  }
  memset(ix->keys, 0xff, (size_t)size * 8);
  ix->mask = (uint64_t)size - 1;
  ix->k = k;
  for (long i = 0; i < n; i++) {
    uint64_t h = mix64(keys[i]) & ix->mask;
    while (ix->keys[h] != EMPTY_KEY) h = (h + 1) & ix->mask;
    ix->keys[h] = keys[i];
    ix->ecs[h] = ecs[i];
    if (aux) ix->aux[h] = aux[i];
  }
  return ix;
}

void seekmer_cpu_free(void *h) {
  cpu_index *ix = (cpu_index *)h;
  if (!ix) return;
  free(ix->keys);
  free(ix->ecs);
  free(ix->aux);
  free(ix);
}

/* Map B reads (codes uint8[B, L], 0-3 = base, >=4 = invalid/pad),
 * single-threaded. Signature counts accumulate into the caller's
 * open-addressing (sig_keys uint64[sig_size] zero-initialized,
 * sig_counts int64[sig_size]) table keyed by a 64-bit signature
 * fingerprint — the compiled analog of the reference's per-worker EC
 * count dict. Returns mapped reads, or -1 if the signature table fills.
 * sig_used_io carries the table's occupancy ACROSS calls (sig_keys
 * persists in the caller, so a per-call counter would let repeated map()
 * calls blow past the load-0.5 bound and degrade probes toward scans);
 * the caller initializes it to 0 with the table. Returns -2, and maps
 * nothing, when max_ecs exceeds MAX_ECS.
 */
long seekmer_cpu_map(void *h, const uint8_t *codes, long B, long L,
                     int max_ecs, uint64_t *sig_keys, int64_t *sig_counts,
                     long sig_size, int64_t *sig_used_io, int use_skip) {
  cpu_index *ix = (cpu_index *)h;
  const int k = ix->k;
  const uint64_t mask2k = (1ULL << (2 * k)) - 1; /* k <= 29 < 32 */
  const int shift_rc = 2 * (k - 1);
  const uint64_t sigmask = (uint64_t)sig_size - 1;
  if (max_ecs > MAX_ECS) return -2;
  long mapped = 0;
  long sig_used = (long)*sig_used_io;

  for (long r = 0; r < B; r++) {
    const uint8_t *row = codes + r * L;
    uint64_t fwd = 0, rc = 0;
    int run = 0; /* consecutive valid bases ending here */
    int skip = 0; /* windows provably sharing the last hit's EC */
    int32_t set[MAX_ECS];
    int ns = 0, complex_read = 0;
    for (long p = 0; p < L; p++) {
      uint8_t c = row[p];
      if (c > 3) { /* invalid base poisons the next k-1 windows */
        run = 0;
        fwd = rc = 0;
        skip = 0;
        continue;
      }
      fwd = ((fwd << 2) | c) & mask2k; /* big-endian 2-bit pack */
      rc = (rc >> 2) | ((uint64_t)(3 - c) << shift_rc);
      if (++run < k) continue;
      if (skip > 0) {
        /* the reference's contig-match-length skipping (SURVEY.md 3.3):
         * the last hit's run length proves the next `aux` windows share
         * its EC in every indexed context, so probing them cannot change
         * the signature set (the caveat of strided mode, --probe-stride: a
         * sequencing-error window inside the run that would have
         * COLLIDED with a different indexed k-mer, ~1e-7/window). The
         * rolling update above still runs — only the probe is saved. */
        skip--;
        continue;
      }
      uint64_t key = fwd < rc ? fwd : rc; /* canonical = min */
      uint64_t s = mix64(key) & ix->mask;
      int32_t ec = -1;
      while (ix->keys[s] != EMPTY_KEY) {
        if (ix->keys[s] == key) {
          ec = ix->ecs[s];
          if (use_skip) skip = ix->aux[s];
          break;
        }
        s = (s + 1) & ix->mask;
      }
      if (ec < 0) continue;
      int found = 0;
      for (int j = 0; j < ns; j++)
        if (set[j] == ec) {
          found = 1;
          break;
        }
      if (!found) {
        if (ns >= max_ecs) { /* complex read: early-out (see header) */
          complex_read = 1;
          break;
        }
        set[ns++] = ec;
      }
    }
    if (ns == 0 || complex_read) continue;
    for (int a = 1; a < ns; a++) { /* sorted signature, like the oracle */
      int32_t v = set[a];
      int b = a - 1;
      while (b >= 0 && set[b] > v) {
        set[b + 1] = set[b];
        b--;
      }
      set[b + 1] = v;
    }
    uint64_t fp = 0xcbf29ce484222325ULL ^ (uint64_t)ns;
    for (int j = 0; j < ns; j++)
      fp = mix64(fp ^ (uint64_t)(uint32_t)set[j] * 0x9E3779B97F4A7C15ULL);
    if (fp == 0) fp = 1; /* 0 = empty slot */
    uint64_t t = fp & sigmask;
    while (sig_keys[t] != 0 && sig_keys[t] != fp) t = (t + 1) & sigmask;
    if (sig_keys[t] == 0) {
      if (2 * ++sig_used > sig_size) { /* keep probes bounded */
        *sig_used_io = sig_used - 1;   /* failed insert was not stored */
        return -1;
      }
      sig_keys[t] = fp;
    }
    sig_counts[t]++;
    mapped++;
  }
  *sig_used_io = sig_used;
  return mapped;
}
