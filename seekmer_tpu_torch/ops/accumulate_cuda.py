"""A1: fold a batch of signatures into the count table (``csrc/accumulate.cu``).

Counterpart of ``seekmer_tpu/map/signature.py`` ``accumulate`` and
``accumulate_direct`` (lines 127-290), which JAX ran in XLA as a
scatter-then-regather compare-and-swap inside a ``while_loop``; there was
no Pallas kernel. In eager PyTorch that loop syncs with the host every
round, so on the card it is one launch of a claim kernel (64-bit
``atomicCAS`` on the key table read as uint64, ``atomicAdd`` counts, the
single-EC direct vector in the same launch) and, when auditing, a second
launch for the collision audit. Each lane walks at most ``sig_probe`` key
buckets, where JAX spends a round per bucket and per lost claim: the
overflow counts agree whenever no lane exhausts its budget, and slot
placement differs, so results are compared after ``merge_sig_rows``.
"""

from __future__ import annotations

import torch

from ..map.signature import SigTable, fold_batch as plain
from . import _build


def fold_batch(table: SigTable, sig: torch.Tensor, mapped: torch.Tensor,
               weights: torch.Tensor | None = None, sig_probe: int = 32,
               audit: bool = True) -> SigTable:
    """Fold (sig int32[B, C], mapped bool[B], weights int32[B] or None)
    into ``table`` in place and return it. CPU tensors take the plain
    version (``map.signature.fold_batch``); CUDA tensors the kernel."""
    if sig.device.type == "cpu":
        return plain(table, sig, mapped, weights=weights,
                     sig_probe=sig_probe, audit=audit)
    B, C = sig.shape
    if sig.dtype != torch.int32 or table.sig.shape[1] != C:
        raise ValueError("sig must be int32 rows of the table's width")
    mapped = mapped.to(torch.bool)
    tensors = [sig, mapped, *table]
    if weights is not None:
        weights = weights.to(torch.int32)
        tensors.append(weights)
    _build.require_cuda("fold_batch", *tensors)
    res_slot = torch.empty(B, dtype=torch.int32, device=sig.device)
    fn = _build.function("seekmer_accumulate", 11, 7)
    w_ptr = None if weights is None else weights.data_ptr()
    _build.check(fn(sig.data_ptr(), mapped.data_ptr(), w_ptr,
                    table.key.data_ptr(), table.count.data_ptr(),
                    table.sig.data_ptr(), table.ec_count.data_ptr(),
                    table.overflow.data_ptr(), table.collisions.data_ptr(),
                    res_slot.data_ptr(), _build.stream_of(sig),
                    sig.device.index, B, C, table.key.shape[0] - 1,
                    table.ec_count.shape[0], sig_probe, int(audit)),
                 "accumulate")
    fold_batch.launches += 1
    return table


fold_batch.launches = 0
