"""Streaming FASTQ(.gz) ingest into fixed-shape read batches: the port's
copy of ``seekmer_tpu/io/fastq.py``. Both packages give equal batches, and
equal cursors, from the same input.

Reads are 2-bit encoded and bucket-padded to a few static lengths
(multiples of ``MapConfig.length_bucket``); padding rows (weight 0) fill the
final partial batch of each bucket. Three sources:

- ``batch_reads_native`` / ``batch_read_pairs_native``: files through the C
  reader and bucketer (``native/packer.c``), every call GIL-released,
  several files decoded in parallel where ``MapConfig.io_workers`` allows;
- ``CheckpointableBatchSource``: files read serially through the same C
  code, with an exact resume cursor on the batches where one is consistent
  (a map checkpoint saves it);
- ``batch_reads`` / ``batch_read_pairs``: reads held in memory, batched in
  Python (``Quantifier.quantify_reads``).

Left out of the copy: the JAX package's no-compiler fallbacks
(``read_fastq``, ``_BucketAccumulator``, ``_PyOffsetFileStream`` and
``CheckpointableBatchSource._iter_py``); the port builds its C library or
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..config import MapConfig
from ..encoding import INVALID, pack_codes_2bit, seq_to_codes


@dataclasses.dataclass
class ReadBatch:
    """One padded device batch (single- or paired-end)."""

    codes: np.ndarray  # uint8[B, L] (INVALID-padded); 2-bit-packed
    # uint8[B, (L+3)//4] when pad_len is set (encoding.pack_codes_2bit)
    lengths: np.ndarray  # int32[B]
    weights: np.ndarray  # int32[B] 1 = real read, 0 = pad row
    codes2: Optional[np.ndarray] = None  # mate 2 (paired-end)
    lengths2: Optional[np.ndarray] = None
    # 2-bit packing (pack_batch_2bit): invalid-base bitmasks + the unpacked
    # padded length L; pad_len is not None <=> codes are packed
    bad: Optional[np.ndarray] = None  # uint8[B, (L+7)//8]
    bad2: Optional[np.ndarray] = None
    pad_len: Optional[int] = None
    # set by utils.prefetch.device_put_batches before weights moves to the
    # device, so n_real never forces a device sync in the feed loop
    n_real_cached: Optional[int] = None
    # resume cursor valid after this batch is consumed (set by
    # CheckpointableBatchSource and io.pack_cache.PackCacheSource where the
    # stream offsets and the pending rows are consistent); host only
    cursor: Optional[dict] = None

    @property
    def n_real(self) -> int:
        if self.n_real_cached is not None:
            return self.n_real_cached
        return int(np.asarray(self.weights).sum())


def pack_batch_2bit(b: ReadBatch) -> ReadBatch:
    """2-bit-pack a batch's code rows on the host (no-op if already
    packed); the pack kernel unpacks them exactly."""
    if b.pad_len is not None:
        return b
    L = b.codes.shape[1]
    codes, bad = pack_codes_2bit(b.codes)
    codes2 = bad2 = None
    if b.codes2 is not None:
        codes2, bad2 = pack_codes_2bit(b.codes2)
    return dataclasses.replace(b, codes=codes, bad=bad, codes2=codes2,
                               bad2=bad2, pad_len=L)


def _bucket_of(length: int, cfg: MapConfig) -> int:
    length = min(max(length, 1), cfg.max_read_len)
    b = cfg.length_bucket
    return ((length + b - 1) // b) * b


def _pack(seqs: list[bytes], L: int, B: int) -> Tuple[np.ndarray, np.ndarray]:
    codes = np.full((B, L), INVALID, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = seq_to_codes(s[:L])
        codes[i, : c.size] = c
        lengths[i] = c.size
    return codes, lengths


def batch_reads(seqs: Iterable[bytes], cfg: MapConfig
                ) -> Iterator[ReadBatch]:
    """Group single-end reads held in memory into fixed-shape batches per
    length bucket."""
    pending: dict[int, list[bytes]] = {}
    B = cfg.batch_size
    for seq in seqs:
        bucket = _bucket_of(len(seq), cfg)
        lst = pending.setdefault(bucket, [])
        lst.append(seq)
        if len(lst) == B:
            codes, lengths = _pack(lst, bucket, B)
            yield ReadBatch(codes, lengths, np.ones(B, np.int32))
            pending[bucket] = []
    for bucket, lst in pending.items():
        if not lst:
            continue
        codes, lengths = _pack(lst, bucket, B)
        w = np.zeros(B, np.int32)
        w[: len(lst)] = 1
        yield ReadBatch(codes, lengths, w)


def batch_read_pairs(pairs: Iterable[Tuple[bytes, bytes]], cfg: MapConfig
                     ) -> Iterator[ReadBatch]:
    """Paired-end batching of reads held in memory; both mates padded to
    the pair's longer mate's bucket."""
    pending: dict[int, list[Tuple[bytes, bytes]]] = {}
    B = cfg.batch_size
    for r1, r2 in pairs:
        bucket = _bucket_of(max(len(r1), len(r2)), cfg)
        lst = pending.setdefault(bucket, [])
        lst.append((r1, r2))
        if len(lst) == B:
            yield _pack_pairs(lst, bucket, B, np.ones(B, np.int32))
            pending[bucket] = []
    for bucket, lst in pending.items():
        if not lst:
            continue
        w = np.zeros(B, np.int32)
        w[: len(lst)] = 1
        yield _pack_pairs(lst, bucket, B, w)


def _pack_pairs(lst, bucket: int, B: int, w: np.ndarray) -> ReadBatch:
    codes1, len1 = _pack([a for a, _ in lst], bucket, B)
    codes2, len2 = _pack([b for _, b in lst], bucket, B)
    return ReadBatch(codes1, len1, w, codes2=codes2, lengths2=len2)


_DONE = object()


def _parallel_chunks(make_streams, workers: int, queue_depth: int = 8):
    """Run the chunk-iterators over at most ``workers`` threads; yield
    items as they arrive. Order is preserved WITHIN each stream, arbitrary
    across streams; the C reader releases the GIL, so multi-file decode
    scales with the threads.

    Each worker drains one stream fully before taking the next. If the
    consumer abandons the generator or a stream raises, a cancel flag
    unblocks producers stuck on the bounded queue and every stream
    generator is closed (its ``finally`` releases the C reader).
    """
    import contextlib
    import queue
    import threading
    import time

    q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    cancel = threading.Event()
    pending = list(enumerate(make_streams))
    lock = threading.Lock()
    n_streams = len(pending)

    def put(item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                if cancel.is_set():
                    return False

    def worker():
        while not cancel.is_set():
            with lock:
                if not pending:
                    return
                _, make = pending.pop(0)
            try:
                stream = make()
                with contextlib.closing(stream):
                    for item in stream:
                        if cancel.is_set() or not put(item):
                            return
                if not put(_DONE):
                    return
            except BaseException as e:  # surface in the consumer
                put(e)
                return

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, min(workers, n_streams)))]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < n_streams:
            item = q.get()
            if item is _DONE:
                done += 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        # drain until every producer has exited (one drain pass can refill
        # from producers already past their cancel check)
        while any(t.is_alive() for t in threads):
            try:
                q.get_nowait()
            except queue.Empty:
                time.sleep(0.01)


def _bucketer_batches(chunk_iter, cfg: MapConfig, paired: bool
                      ) -> Iterator[ReadBatch]:
    """Drain decoded chunks through the C bucketer into ReadBatches."""
    from ..native.packer import Bucketer

    B = cfg.batch_size
    bk = Bucketer(B, cfg.max_read_len, cfg.length_bucket, paired)
    try:
        for chunk in chunk_iter:
            if paired:
                c1, l1, c2, l2 = chunk
            else:
                (c1, l1), c2, l2 = chunk, None, None
            if bk.feed(c1, l1, c2, l2):
                for c1b, l1b, c2b, l2b, _ in bk.pop_ready():
                    yield ReadBatch(c1b, l1b, np.ones(B, np.int32),
                                    codes2=c2b, lengths2=l2b)
        for c1b, l1b, c2b, l2b, fill in bk.flush():
            w = np.zeros(B, np.int32)
            w[:fill] = 1
            yield ReadBatch(c1b, l1b, w, codes2=c2b, lengths2=l2b)
    finally:
        bk.close()


def batch_reads_native(paths, cfg: MapConfig) -> Iterator[ReadBatch]:
    """Single-end batching through the C reader and bucketer. With several
    input files and ``cfg.io_workers != 1``, files decode concurrently
    (read order interleaves across files; counts do not depend on it)."""
    from ..native.packer import stream_packed

    paths = list(paths)
    w = cfg.io_workers if cfg.io_workers > 0 else 4
    workers = min(w, len(paths))
    if workers > 1:
        makers = [
            (lambda p=p: stream_packed(p, cfg.max_read_len)) for p in paths
        ]
        chunk_iter = _parallel_chunks(makers, workers)
    else:
        def serial():
            for path in paths:
                yield from stream_packed(path, cfg.max_read_len)

        chunk_iter = serial()
    yield from _bucketer_batches(chunk_iter, cfg, paired=False)


def _aligned_chunks(stream1, stream2):
    """Zip two (codes, lengths) block streams into row-aligned sub-blocks."""
    buf1 = buf2 = None
    pos1 = pos2 = 0
    while True:
        if buf1 is None or pos1 == buf1[0].shape[0]:
            buf1, pos1 = next(stream1, None), 0
        if buf2 is None or pos2 == buf2[0].shape[0]:
            buf2, pos2 = next(stream2, None), 0
        if buf1 is None or buf2 is None:
            if (buf1 is None) != (buf2 is None):
                raise ValueError("paired FASTQ files have unequal read counts")
            return
        n = min(buf1[0].shape[0] - pos1, buf2[0].shape[0] - pos2)
        yield (buf1[0][pos1 : pos1 + n], buf1[1][pos1 : pos1 + n],
               buf2[0][pos2 : pos2 + n], buf2[1][pos2 : pos2 + n])
        pos1 += n
        pos2 += n


def batch_read_pairs_native(paths1, paths2, cfg: MapConfig
                            ) -> Iterator[ReadBatch]:
    """Paired-end batching through the C reader and bucketer; mates bucket
    together by the pair's longer mate. Files decode in parallel only when
    ``cfg.io_workers > 1`` and the mate files pair index by index; by
    default the two concatenated streams are aligned serially."""
    from ..native.packer import stream_packed

    def stream(paths):
        for p in paths:
            yield from stream_packed(p, cfg.max_read_len)

    paths1, paths2 = list(paths1), list(paths2)
    if (cfg.io_workers > 1 and len(paths1) == len(paths2)
            and len(paths1) > 1):
        def pair_stream(p1, p2):
            try:
                yield from _aligned_chunks(
                    stream_packed(p1, cfg.max_read_len),
                    stream_packed(p2, cfg.max_read_len))
            except ValueError as e:
                raise ValueError(
                    f"{e} ({p1} / {p2}): with --io-workers > 1, mate files "
                    "must pair index-by-index; re-run with --io-workers 1 "
                    "to align the concatenated streams instead") from e

        makers = [
            (lambda a=p1, b=p2: pair_stream(a, b))
            for p1, p2 in zip(paths1, paths2)
        ]
        chunk_iter = _parallel_chunks(makers, min(cfg.io_workers,
                                                  len(paths1)))
    else:
        chunk_iter = _aligned_chunks(stream(paths1), stream(paths2))
    yield from _bucketer_batches(chunk_iter, cfg, paired=True)


# ---- checkpointable (offset-cursor) batching -------------------------------


class _OffsetStream:
    """Chained multi-file FASTQ stream with an exact (file_idx, offset)
    cursor; offset = uncompressed byte position of the next unparsed
    record. Resume reopens there: a plain file seeks, a .gz file is
    inflated and discarded up to it in one C call."""

    def __init__(self, paths, max_len: int, file_idx: int = 0,
                 offset: int = 0):
        self.paths = list(paths)
        self.max_len = max_len
        self.file_idx = file_idx
        self.offset = offset
        self._cur = None

    def read_n(self, n: int):
        """Up to ``n`` reads (fewer only at the end of all files),
        advancing the cursor; None when exhausted."""
        from ..native.packer import PackedFileStream

        out_c, out_l = [], []
        got = 0
        while got < n and self.file_idx < len(self.paths):
            if self._cur is None:
                self._cur = PackedFileStream(self.paths[self.file_idx],
                                             self.max_len,
                                             start_offset=self.offset)
            chunk = self._cur.next_chunk(n - got)
            if chunk is None:
                self._cur.close()
                self._cur = None
                self.file_idx += 1
                self.offset = 0
                continue
            self.offset = self._cur.tell()
            out_c.append(chunk[0])
            out_l.append(chunk[1])
            got += chunk[0].shape[0]
        if not out_c:
            return None
        if len(out_c) == 1:
            return out_c[0], out_l[0]
        return np.concatenate(out_c), np.concatenate(out_l)

    def cursor(self):
        return [self.file_idx, self.offset]

    def close(self) -> None:
        if self._cur is not None:
            self._cur.close()
            self._cur = None


class CheckpointableBatchSource:
    """Serial FASTQ batching with an exact resume cursor.

    The cursor is each stream's (file index, uncompressed byte offset of
    the next unparsed record) plus the rows of the partial buckets and the
    count of batches made before it (``"batch"``), so a
    checkpoint taken at a batch boundary resumes without re-reading or
    re-batching consumed input: the rows the bucketer held ride in the
    checkpoint (``utils/checkpoint``). Cursors ride on the last batch made
    from each decoded chunk (``ReadBatch.cursor``), where the offsets and
    the pending rows agree; ``Mapper.run`` saves at the next such batch
    after each ``checkpoint_every`` interval. Decoding is serial whatever
    ``MapConfig.io_workers`` says: the cursor needs one read order.
    """

    CHUNK = 16384

    def __init__(self, paths, mate_paths=None, cfg: MapConfig = MapConfig()):
        self.paths = list(paths)
        self.mates = list(mate_paths) if mate_paths else None
        self.cfg = cfg
        self._restore_state: Optional[dict] = None

    def restore(self, state: dict) -> None:
        if state.get("v") == "pack1":
            raise ValueError(
                "checkpoint was taken on a --pack-cache run (its cursor "
                "indexes cached batches, not file offsets); resume with "
                "--pack-cache, or delete the checkpoint to start fresh")
        if state.get("paired", False) != (self.mates is not None):
            raise ValueError("checkpoint cursor pairing does not match "
                             "the current input files")
        self._restore_state = state

    def _snapshot(self, s1, s2, bk, batches: int) -> dict:
        return {
            "v": 1,
            "paired": self.mates is not None,
            "s1": s1.cursor(),
            "s2": s2.cursor() if s2 is not None else None,
            "pending": bk.pending_state(),
            "batch": batches,
        }

    def __iter__(self) -> Iterator[ReadBatch]:
        from ..native.packer import Bucketer

        cfg = self.cfg
        B = cfg.batch_size
        st0 = self._restore_state or {}
        f1, o1 = st0.get("s1") or (0, 0)
        s1 = _OffsetStream(self.paths, cfg.max_read_len, f1, o1)
        s2 = None
        if self.mates is not None:
            f2, o2 = st0.get("s2") or (0, 0)
            s2 = _OffsetStream(self.mates, cfg.max_read_len, f2, o2)
        paired = s2 is not None
        # batches made from the start of the input: the next one's global
        # index, which a cursor carries (``rank_batches`` deals by it)
        made = int(st0.get("batch", 0))
        bk = Bucketer(B, cfg.max_read_len, cfg.length_bucket, paired)
        try:
            if st0.get("pending"):
                bk.restore_pending(
                    {int(k): v for k, v in st0["pending"].items()})
            while True:
                ch1 = s1.read_n(self.CHUNK)
                if ch1 is None:
                    if s2 is not None and s2.read_n(1) is not None:
                        raise ValueError(
                            "paired FASTQ files have unequal read counts")
                    break
                c1, l1 = ch1
                c2 = l2 = None
                if paired:
                    ch2 = s2.read_n(c1.shape[0])
                    if ch2 is None or ch2[0].shape[0] != c1.shape[0]:
                        raise ValueError(
                            "paired FASTQ files have unequal read counts")
                    c2, l2 = ch2
                bk.feed(c1, l1, c2, l2)
                out = [
                    ReadBatch(a, b, np.ones(B, np.int32),
                              codes2=cc, lengths2=dd)
                    for a, b, cc, dd, _ in bk.pop_ready()
                ]
                made += len(out)
                for batch in out[:-1]:
                    yield batch
                if out:
                    out[-1].cursor = self._snapshot(s1, s2, bk, made)
                    yield out[-1]
            # flush the partial buckets; each flushed batch's cursor leaves
            # out the buckets already flushed
            for a, b, cc, dd, fill in bk.flush():
                w = np.zeros(B, np.int32)
                w[:fill] = 1
                batch = ReadBatch(a, b, w, codes2=cc, lengths2=dd)
                made += 1
                batch.cursor = self._snapshot(s1, s2, bk, made)
                yield batch
        finally:
            bk.close()
            s1.close()
            if s2 is not None:
                s2.close()


def rank_batches(batches: Iterable[ReadBatch], rank: int, world: int,
                 first: int = 0) -> Iterator[ReadBatch]:
    """Rank ``rank``'s share of a batch stream that every rank reads whole:
    global batch g (counted from ``first``, a restored cursor's
    ``"batch"``) goes to rank g mod ``world``.

    A kept batch leaves with the latest cursor among itself and the
    batches after it that go to other ranks: once it is mapped, resuming
    after any of those maps nothing twice and skips nothing of this rank.
    So a kept batch carries a cursor whenever the stream had one before
    this rank's next batch, and each kept batch is held until that next
    batch (or the end) is read."""
    held = cursor = None
    for g, batch in enumerate(batches, first):
        mine = g % world == rank
        if mine and held is not None:
            held.cursor = cursor
            yield held
            held = None
        if mine:
            held, cursor = batch, batch.cursor
        elif held is not None and batch.cursor is not None:
            cursor = batch.cursor
    if held is not None:
        held.cursor = cursor
        yield held
