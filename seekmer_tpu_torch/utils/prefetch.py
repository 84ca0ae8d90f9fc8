"""Upload read batches ahead of the map loop: counterpart of
``seekmer_tpu/utils/prefetch.device_put_batches``, and ``prefetch``, the
bounded background-thread queue, copied from that module."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, TypeVar

import numpy as np
import torch

from ..io.fastq import pack_batch_2bit

T = TypeVar("T")

_SENTINEL = object()


def _put(a, device: torch.device):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        # pinned source: the copy is asynchronous, and the caching host
        # allocator keeps the buffer alive until the copy has run
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_put_batches(batches, device):
    """2-bit pack each ReadBatch on the host (``io.fastq.pack_batch_2bit``)
    and upload its arrays to ``device``, so the feed loop never touches
    numpy. ``n_real`` is taken on the host first, so read accounting never
    syncs with the device. Run it on ``prefetch``'s producer thread to
    overlap ingest and upload with the map steps."""
    device = torch.device(device)
    for b in batches:
        n_real = b.n_real
        b = pack_batch_2bit(b)
        yield dataclasses.replace(
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


def prefetch(items: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Iterate ``items`` on a daemon thread, buffering up to ``depth``;
    an exception of the producer is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error = []

    def worker():
        try:
            for item in items:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
