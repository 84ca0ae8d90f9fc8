"""Streaming FASTQ(.gz) ingest into fixed-shape read batches: the port's
copy of ``seekmer_tpu/io/fastq.py``, with the C path the port runs
(``batch_reads_native``, ``batch_read_pairs_native``) and the 2-bit
host pack of a batch. Both packages give equal batches from the same files.

Reads are 2-bit encoded and bucket-padded to a few static lengths
(multiples of ``MapConfig.length_bucket``); padding rows (weight 0) fill the
final partial batch of each bucket. Decode and bucket placement run in
GIL-released C calls (``native/packer.c``).

Left out of the copy: the pure-Python readers and batchers, which the JAX
package falls back to without a C compiler (the port builds its C library
or raises), and the checkpointable offset-cursor source (ROADMAP.md, still
to port: Checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..config import MapConfig
from ..encoding import pack_codes_2bit


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
