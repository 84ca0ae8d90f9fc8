/* Native host ingest and index sort of the port: the port's copy of
 * seekmer_tpu/native/packer.c, with the entry points the port calls.
 *
 *   seekmer_open/next/close: a streaming FASTQ(.gz) reader that does file
 *     I/O, gzip inflate (zlib gzFile, which reads plain files too), parse
 *     and 2-bit-code packing (A=0 C=1 G=2 T=3, other=4) in ONE call, so a
 *     ctypes call releases the GIL for the whole decode;
 *   seekmer_bucketer_*: groups decoded rows into fixed-shape per-length-
 *     bucket batches, also GIL-released;
 *   seekmer_sort_pairs: the threaded stable radix sort of (key, transcript)
 *     pairs of the index build.
 *
 * Repaired in this copy: the radix sort covers every key bit (the pass
 * count follows the widest key: 2k <= 58 bits for k <= 29, where four
 * fixed 13-bit passes covered 52), and seekmer_bucketer_new frees what it
 * allocated when an allocation fails.
 *
 * Built at first use by native/packer.py into build/seekmer_tpu_torch/:
 * cc -O3 -shared -fPIC -pthread packer.c -lz
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

static uint8_t LUT[256];

__attribute__((constructor)) static void init_lut(void) {
  for (int i = 0; i < 256; i++) LUT[i] = 4;
  LUT['A'] = 0; LUT['a'] = 0;
  LUT['C'] = 1; LUT['c'] = 1;
  LUT['G'] = 2; LUT['g'] = 2;
  LUT['T'] = 3; LUT['t'] = 3;
}

/* Parse complete FASTQ records from buf[0..len) and pack sequence rows.
 *
 * codes:   uint8 [max_reads, max_len], each row INVALID(4)-padded
 * lengths: int32 [max_reads] (clipped to max_len)
 * consumed: bytes of complete records parsed (caller carries the tail over)
 *
 * Returns reads parsed (>= 0), or -1 on malformed input.
 */
static long pack_fastq(const uint8_t *buf, long len, uint8_t *codes,
                        int32_t *lengths, long max_reads, long max_len,
                        long *consumed) {
  long n = 0, i = 0;
  *consumed = 0;
  while (n < max_reads) {
    if (i >= len) break;
    if (buf[i] != '@') return -1;
    while (i < len && buf[i] != '\n') i++;       /* header */
    if (i >= len) break;
    i++;
    long s = i;
    while (i < len && buf[i] != '\n') i++;       /* sequence */
    if (i >= len) break;
    long slen = i - s;
    if (slen > 0 && buf[s + slen - 1] == '\r') slen--;
    i++;
    if (i >= len) break;
    if (buf[i] != '+') return -1;
    while (i < len && buf[i] != '\n') i++;       /* separator */
    if (i >= len) break;
    i++;
    while (i < len && buf[i] != '\n') i++;       /* quality */
    if (i >= len) break;
    i++;

    long L = slen < max_len ? slen : max_len;
    uint8_t *row = codes + n * max_len;
    for (long j = 0; j < L; j++) row[j] = LUT[buf[s + j]];
    memset(row + L, 4, max_len - L);
    lengths[n] = (int32_t)L;
    n++;
    *consumed = i;
  }
  return n;
}

/* ---- streaming reader: gzFile -> packed code rows ---------------------- */

typedef struct {
  gzFile gz;
  uint8_t *buf;
  long cap, len;
  int eof;
} seekmer_reader;

void *seekmer_open(const char *path) {
  seekmer_reader *r = (seekmer_reader *)calloc(1, sizeof(seekmer_reader));
  if (!r) return NULL;
  r->gz = gzopen(path, "rb");
  if (!r->gz) { free(r); return NULL; }
  gzbuffer(r->gz, 1 << 20);
  r->cap = 4l << 20;
  r->buf = (uint8_t *)malloc(r->cap);
  if (!r->buf) { gzclose(r->gz); free(r); return NULL; }
  return r;
}

/* Fill up to max_reads code rows. Returns reads produced (0 = clean EOF),
 * -1 malformed input, -2 I/O error. One call does file read + inflate +
 * parse + pack — the caller's ctypes invocation releases the GIL for all
 * of it. */
long seekmer_next(void *h, uint8_t *codes, int32_t *lengths, long max_reads,
                  long max_len) {
  seekmer_reader *r = (seekmer_reader *)h;
  for (;;) {
    if (r->len > 0) {
      long consumed = 0;
      long n = pack_fastq(r->buf, r->len, codes, lengths, max_reads,
                                  max_len, &consumed);
      if (n < 0) return -1;
      if (n > 0) {
        memmove(r->buf, r->buf + consumed, r->len - consumed);
        r->len -= consumed;
        return n;
      }
    }
    if (r->eof) {
      /* no complete record left: only whitespace may remain */
      for (long j = 0; j < r->len; j++)
        if (r->buf[j] != '\n' && r->buf[j] != '\r' && r->buf[j] != ' ' &&
            r->buf[j] != '\t')
          return -1;
      return 0;
    }
    if (r->len == r->cap) { /* single record larger than the buffer */
      long nc = r->cap * 2;
      uint8_t *nb = (uint8_t *)realloc(r->buf, nc);
      if (!nb) return -2;
      r->buf = nb;
      r->cap = nc;
    }
    int got = gzread(r->gz, r->buf + r->len, (unsigned)(r->cap - r->len));
    if (got < 0) return -2;
    if (got == 0) {
      /* distinguish clean EOF from a TRUNCATED gzip stream: premature end
       * of a member leaves gzerror at Z_BUF_ERROR ("unexpected end of
       * file") while gzread still returns 0 — treating that as EOF
       * silently drops every read past the cut (a truncated .gz whose
       * recoverable prefix ends on a record boundary "succeeds"). */
      int errnum = Z_OK;
      gzerror(r->gz, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) return -2;
      r->eof = 1;
    }
    r->len += got;
  }
}

void seekmer_close(void *h) {
  seekmer_reader *r = (seekmer_reader *)h;
  if (!r) return;
  if (r->gz) gzclose(r->gz);
  free(r->buf);
  free(r);
}

/* ---- bucketer: decoded chunks -> fixed-shape per-bucket batches -------- */
/* Group rows by padded length bucket and copy them into fixed (B, W) batch
 * buffers in C, so every ctypes call of the ingest loop releases the GIL.
 *
 * Rows fed here are decoder output: uint8[n, max_len], INVALID(4)-padded.
 * A row of effective length e (paired: max of the mates) lands in bucket
 * index ceil(e/lb)-1 whose width is min((idx+1)*lb, max_len). Full batches
 * move (not copy) onto a ready queue; seekmer_bucketer_pop copies one batch
 * into caller numpy buffers. */

typedef struct bkt_ready {
  long w, fill;
  uint8_t *c1; int32_t *l1;
  uint8_t *c2; int32_t *l2;
  struct bkt_ready *next;
} bkt_ready;

typedef struct {
  long B, max_len, lb, nb;
  int paired;
  uint8_t **c1; int32_t **l1;   /* per-bucket pending, row width = bucket */
  uint8_t **c2; int32_t **l2;
  long *fill;
  bkt_ready *head, *tail;
} seekmer_bucketer;

static long bkt_width(const seekmer_bucketer *b, long idx) {
  long w = (idx + 1) * b->lb;
  return w < b->max_len ? w : b->max_len;
}

void *seekmer_bucketer_new(long batch_size, long max_len, long length_bucket,
                           int paired) {
  seekmer_bucketer *b =
      (seekmer_bucketer *)calloc(1, sizeof(seekmer_bucketer));
  if (!b) return NULL;
  b->B = batch_size;
  b->max_len = max_len;
  b->lb = length_bucket;
  b->nb = (max_len + length_bucket - 1) / length_bucket;
  b->paired = paired;
  b->c1 = (uint8_t **)calloc(b->nb, sizeof(uint8_t *));
  b->l1 = (int32_t **)calloc(b->nb, sizeof(int32_t *));
  b->c2 = (uint8_t **)calloc(b->nb, sizeof(uint8_t *));
  b->l2 = (int32_t **)calloc(b->nb, sizeof(int32_t *));
  b->fill = (long *)calloc(b->nb, sizeof(long));
  if (!b->c1 || !b->l1 || !b->c2 || !b->l2 || !b->fill) {
    free(b->c1); free(b->l1); free(b->c2); free(b->l2); free(b->fill);
    free(b);
    return NULL;
  }
  return b;
}

static int bkt_alloc_pending(seekmer_bucketer *b, long idx) {
  long w = bkt_width(b, idx);
  b->c1[idx] = (uint8_t *)malloc(b->B * w);
  b->l1[idx] = (int32_t *)calloc(b->B, sizeof(int32_t));
  if (!b->c1[idx] || !b->l1[idx]) return -1;
  if (b->paired) {
    b->c2[idx] = (uint8_t *)malloc(b->B * w);
    b->l2[idx] = (int32_t *)calloc(b->B, sizeof(int32_t));
    if (!b->c2[idx] || !b->l2[idx]) return -1;
  }
  return 0;
}

/* Move bucket idx's full pending buffers onto the ready queue. */
static int bkt_promote(seekmer_bucketer *b, long idx) {
  bkt_ready *r = (bkt_ready *)calloc(1, sizeof(bkt_ready));
  if (!r) return -1;
  r->w = bkt_width(b, idx);
  r->fill = b->fill[idx];
  r->c1 = b->c1[idx]; r->l1 = b->l1[idx];
  r->c2 = b->c2[idx]; r->l2 = b->l2[idx];
  b->c1[idx] = NULL; b->l1[idx] = NULL;
  b->c2[idx] = NULL; b->l2[idx] = NULL;
  b->fill[idx] = 0;
  if (b->tail) b->tail->next = r; else b->head = r;
  b->tail = r;
  return 0;
}

/* Feed n decoded rows (width max_len). Returns batches now ready, -2 OOM. */
long seekmer_bucketer_feed(void *h, const uint8_t *c1, const int32_t *l1,
                           const uint8_t *c2, const int32_t *l2, long n) {
  seekmer_bucketer *b = (seekmer_bucketer *)h;
  for (long i = 0; i < n; i++) {
    long e = l1[i];
    if (b->paired && l2[i] > e) e = l2[i];
    if (e < 1) e = 1;
    if (e > b->max_len) e = b->max_len;
    long idx = (e + b->lb - 1) / b->lb - 1;
    long w = bkt_width(b, idx);
    if (!b->c1[idx] && bkt_alloc_pending(b, idx) != 0) return -2;
    long f = b->fill[idx];
    memcpy(b->c1[idx] + f * w, c1 + i * b->max_len, w);
    b->l1[idx][f] = l1[i] < w ? l1[i] : (int32_t)w;
    if (b->paired) {
      memcpy(b->c2[idx] + f * w, c2 + i * b->max_len, w);
      b->l2[idx][f] = l2[i] < w ? l2[i] : (int32_t)w;
    }
    if (++b->fill[idx] == b->B && bkt_promote(b, idx) != 0) return -2;
  }
  long ready = 0;
  for (bkt_ready *r = b->head; r; r = r->next) ready++;
  return ready;
}

/* Width of the oldest ready batch, 0 if none. */
long seekmer_bucketer_ready_width(void *h) {
  seekmer_bucketer *b = (seekmer_bucketer *)h;
  return b->head ? b->head->w : 0;
}

/* Pop the oldest ready batch into caller buffers sized (B, W)/(B,).
 * Returns its real-row count (== B for feed-promoted batches). */
long seekmer_bucketer_pop(void *h, uint8_t *c1, int32_t *l1, uint8_t *c2,
                          int32_t *l2) {
  seekmer_bucketer *b = (seekmer_bucketer *)h;
  bkt_ready *r = b->head;
  if (!r) return 0;
  b->head = r->next;
  if (!b->head) b->tail = NULL;
  memcpy(c1, r->c1, b->B * r->w);
  memcpy(l1, r->l1, b->B * sizeof(int32_t));
  if (b->paired) {
    memcpy(c2, r->c2, b->B * r->w);
    memcpy(l2, r->l2, b->B * sizeof(int32_t));
  }
  long fill = r->fill;
  free(r->c1); free(r->l1); free(r->c2); free(r->l2); free(r);
  return fill;
}

/* Promote the lowest-index pending partial bucket to the ready queue
 * (EOF flush). Returns its fill count, 0 when nothing is pending. */
long seekmer_bucketer_flush_one(void *h) {
  seekmer_bucketer *b = (seekmer_bucketer *)h;
  for (long idx = 0; idx < b->nb; idx++)
    if (b->fill[idx] > 0) {
      long fill = b->fill[idx];
      /* zero the unused tail rows so pad rows are deterministic */
      long w = bkt_width(b, idx);
      memset(b->c1[idx] + fill * w, 4, (b->B - fill) * w);
      if (b->paired) memset(b->c2[idx] + fill * w, 4, (b->B - fill) * w);
      if (bkt_promote(b, idx) != 0) return -2;
      return fill;
    }
  return 0;
}

void seekmer_bucketer_free(void *h) {
  seekmer_bucketer *b = (seekmer_bucketer *)h;
  if (!b) return;
  for (long i = 0; i < b->nb; i++) {
    free(b->c1[i]); free(b->l1[i]); free(b->c2[i]); free(b->l2[i]);
  }
  free(b->c1); free(b->l1); free(b->c2); free(b->l2); free(b->fill);
  for (bkt_ready *r = b->head; r;) {
    bkt_ready *n = r->next;
    free(r->c1); free(r->l1); free(r->c2); free(r->l2); free(r);
    r = n;
  }
  free(b);
}

/* ---- threaded stable radix sort of (key, tid) pairs -------------------- */
/* The index build's pair sort: group_equivalence_classes sorts (canonical
 * k-mer key, transcript id) pairs by key, stable in stream order. This is
 * a payload-carrying LSD radix sort of 13-bit digits, as many passes as the
 * widest key needs (2k bits: 4 passes up to k = 26, 5 up to k = 32), plus
 * one rank pass, threaded, inside a GIL-released ctypes call. Stability
 * makes it byte-identical to numpy's stable argsort downstream.
 */

#include <pthread.h>

#define RADIX_BITS 13
#define RADIX_BUCKETS (1l << RADIX_BITS)

typedef struct {
  uint64_t key, payload; /* payload = orig_index<<32 | tid */
} kt_rec;

typedef struct {
  const kt_rec *src;
  kt_rec *dst;
  long lo, hi;      /* this thread's input slice */
  long *hist;       /* this thread's RADIX_BUCKETS histogram (one pass) */
  long *offs;       /* scatter offsets for one pass (filled by driver) */
  int pass;
} radix_job;

/* Per-pass per-thread counting: elements MOVE between passes, so each
 * pass must recount the digit distribution of each thread's CURRENT
 * slice (a one-shot all-pass pre-count is only valid single-threaded —
 * the bug class this comment exists to prevent). */
static void *radix_count(void *arg) {
  radix_job *j = (radix_job *)arg;
  int shift = j->pass * RADIX_BITS;
  memset(j->hist, 0, RADIX_BUCKETS * sizeof(long));
  for (long i = j->lo; i < j->hi; i++)
    j->hist[(j->src[i].key >> shift) & (RADIX_BUCKETS - 1)]++;
  return NULL;
}

static void *radix_scatter(void *arg) {
  radix_job *j = (radix_job *)arg;
  int shift = j->pass * RADIX_BITS;
  for (long i = j->lo; i < j->hi; i++) {
    kt_rec r = j->src[i];
    long d = (r.key >> shift) & (RADIX_BUCKETS - 1);
    j->dst[j->offs[d]++] = r;
  }
  return NULL;
}

/* Sort (keys, tids) by key, stable in input order; write sorted keys and
 * tids, and (when key_rank_out != NULL) each INPUT position's rank into
 * the sorted unique keys. Returns the unique-key count, or -2 on OOM. */
long seekmer_sort_pairs(const uint64_t *keys, const int32_t *tids, long n,
                        uint64_t *keys_out, int32_t *tids_out,
                        int64_t *key_rank_out, int nthreads) {
  if (n == 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  kt_rec *a = (kt_rec *)malloc(n * sizeof(kt_rec));
  kt_rec *b = (kt_rec *)malloc(n * sizeof(kt_rec));
  long *hist = (long *)malloc((size_t)nthreads * RADIX_BUCKETS *
                              sizeof(long));
  long *offs = (long *)malloc((size_t)nthreads * RADIX_BUCKETS *
                              sizeof(long));
  pthread_t th[16];
  radix_job jobs[16];
  if (!a || !b || !hist || !offs) {
    free(a); free(b); free(hist); free(offs);
    return -2;
  }
  uint64_t all_bits = 0;
  for (long i = 0; i < n; i++) {
    a[i].key = keys[i];
    a[i].payload = ((uint64_t)i << 32) | (uint32_t)tids[i];
    all_bits |= keys[i];
  }
  int passes = 0; /* digits up to the highest set bit of any key */
  while (passes * RADIX_BITS < 64 && (all_bits >> (passes * RADIX_BITS)))
    passes++;
  long chunk = (n + nthreads - 1) / nthreads;
  kt_rec *src = a, *dst = b;
  for (int pass = 0; pass < passes; pass++) {
    for (int t = 0; t < nthreads; t++) {
      jobs[t].src = src;
      jobs[t].lo = t * chunk < n ? t * chunk : n;
      jobs[t].hi = (t + 1) * chunk < n ? (t + 1) * chunk : n;
      jobs[t].hist = hist + (size_t)t * RADIX_BUCKETS;
      jobs[t].pass = pass;
      if (t + 1 < nthreads)
        pthread_create(&th[t], NULL, radix_count, &jobs[t]);
      else
        radix_count(&jobs[t]);
    }
    for (int t = 0; t + 1 < nthreads; t++)
      pthread_join(th[t], NULL);
    /* global stable offsets: bucket-major, thread-minor */
    long run = 0;
    for (long d = 0; d < RADIX_BUCKETS; d++)
      for (int t = 0; t < nthreads; t++) {
        offs[(size_t)t * RADIX_BUCKETS + d] = run;
        run += hist[(size_t)t * RADIX_BUCKETS + d];
      }
    for (int t = 0; t < nthreads; t++) {
      jobs[t].src = src;
      jobs[t].dst = dst;
      jobs[t].offs = offs + (size_t)t * RADIX_BUCKETS;
      if (t + 1 < nthreads)
        pthread_create(&th[t], NULL, radix_scatter, &jobs[t]);
      else
        radix_scatter(&jobs[t]);
    }
    for (int t = 0; t + 1 < nthreads; t++)
      pthread_join(th[t], NULL);
    kt_rec *tmp = src;
    src = dst;
    dst = tmp;
  }

  /* emit + rank pass (sequential: compares neighbors) */
  long uniq = 0;
  for (long i = 0; i < n; i++) {
    uint64_t k = src[i].key;
    keys_out[i] = k;
    tids_out[i] = (int32_t)(uint32_t)src[i].payload;
    if (i == 0 || k != src[i - 1].key) uniq++;
    if (key_rank_out)
      key_rank_out[src[i].payload >> 32] = uniq - 1;
  }
  free(a); free(b); free(hist); free(offs);
  return uniq;
}
