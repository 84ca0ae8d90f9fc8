"""Upload read batches ahead of the map loop: counterpart of
``seekmer_tpu/utils/prefetch.device_put_batches``, and ``prefetch``, the
bounded background-thread queue, copied from that module. A batch's
resume cursor rides through both."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

from ..io.fastq import pack_batch_2bit
from .metrics import Metrics

T = TypeVar("T")

_SENTINEL = object()


def _put(a, device: torch.device):
    """One host array on ``device``. For a card it is copied once into
    pinned memory, from which the upload is asynchronous (the caching host
    allocator keeps the buffer alive until the copy has run); a read-only
    array (a pack cache's memmap slice) is never wrapped, only copied."""
    if a is None:
        return None
    if device.type == "cuda":
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        np.copyto(pinned.numpy(), a)
        return pinned.to(device, non_blocking=True)
    if not a.flags.writeable:
        a = np.array(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_put_batches(batches, device, metrics: Metrics | None = None):
    """2-bit pack each ReadBatch on the host (``io.fastq.pack_batch_2bit``)
    and upload its arrays to ``device``, so the feed loop never touches
    numpy. ``n_real`` is taken on the host first, so read accounting never
    syncs with the device. Run it on ``prefetch``'s producer thread to
    overlap ingest and upload with the map steps. The spans of ``metrics``
    (``Metrics.span``: timers and trace ranges) ``ingest`` (taking the
    next batch from ``batches``) and ``upload`` name the two, and ``pack``
    the 2-bit pack inside ``upload``."""
    device = torch.device(device)
    metrics = metrics if metrics is not None else Metrics()
    it = iter(batches)
    while True:
        with metrics.span("ingest"):
            b = next(it, None)
        if b is None:
            return
        with metrics.span("upload"):
            n_real = b.n_real
            with metrics.span("pack"):
                b = pack_batch_2bit(b)
            out = dataclasses.replace(
                b,
                codes=_put(b.codes, device),
                lengths=_put(b.lengths, device),
                weights=_put(b.weights, device),
                codes2=_put(b.codes2, device),
                lengths2=_put(b.lengths2, device),
                bad=_put(b.bad, device),
                bad2=_put(b.bad2, device),
                n_real_cached=n_real,
            )
        yield out


def prefetch(items: Iterable[T], depth: int = 4,
             metrics: Metrics | None = None) -> Iterator[T]:
    """Iterate ``items`` on a daemon thread, buffering up to ``depth``;
    an exception of the producer is raised in the consumer. A consumer
    that stops early (a crash, a checkpoint test's stop) stops the
    producer, which closes ``items`` (its readers release their files)
    and ends; the consumer waits for it. The span ``map_wait`` of
    ``metrics`` times each wait of the consumer for the next item (the
    end of ``items`` included)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in items:
                if not put(item):
                    break
        except BaseException as e:  # propagate into the consumer
            error.append(e)
        finally:
            close = getattr(items, "close", None)
            if stop.is_set() and close is not None:
                close()
            put(_SENTINEL)

    metrics = metrics if metrics is not None else Metrics()
    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with metrics.span("map_wait"):
                item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
