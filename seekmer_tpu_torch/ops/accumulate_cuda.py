"""A1: fold a batch of signatures into the count table (``csrc/accumulate.cu``).

Counterpart of ``seekmer_tpu/map/signature.py`` ``accumulate`` and
``accumulate_direct`` (lines 127-290), which JAX ran in XLA as a
scatter-then-regather compare-and-swap inside a ``while_loop``; there was
no Pallas kernel. In eager PyTorch that loop syncs with the host every
round, so on the card it is one launch: a warp stages its 32 reads' rows
in shared memory, single-EC rows count into the direct vector, the rest
claim or match their fingerprint's slot (the whole key bucket in one read,
64-bit ``atomicCAS`` on the key table read as uint64). With the audit on,
the launch is cooperative, and after one grid barrier only the reads that
matched an existing key compare their row with the stored one. Each lane
walks at most ``sig_probe`` key buckets, where JAX spends a round per
bucket and per lost claim: the overflow counts agree whenever no lane
exhausts its budget, and slot placement differs, so results are compared
after ``merge_sig_rows``.
"""

from __future__ import annotations

import torch

from ..map.signature import SigTable, fold_batch as plain
from . import _build

WARPS = 8  # csrc/accumulate.cu: 32 reads a warp, 8 warps a block
MAX_C = 200  # widest row whose block of 256 staged rows fits shared memory


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
    if C > MAX_C:
        raise ValueError(f"rows of {C} EC ids exceed the kernel's {MAX_C}")
    if mapped.dtype != torch.bool:
        mapped = mapped.to(torch.bool)
    if weights is None:
        _build.require_cuda("fold_batch", sig, mapped, *table)
        w_ptr = None
    else:
        if weights.dtype != torch.int32:
            weights = weights.to(torch.int32)
        _build.require_cuda("fold_batch", sig, mapped, weights, *table)
        w_ptr = weights.data_ptr()
    fn = _build.function("seekmer_accumulate", 10, 7)
    _build.check(fn(sig.data_ptr(), mapped.data_ptr(), w_ptr,
                    table.key.data_ptr(), table.count.data_ptr(),
                    table.sig.data_ptr(), table.ec_count.data_ptr(),
                    table.overflow.data_ptr(), table.collisions.data_ptr(),
                    _build.stream_of(sig), sig.device.index, B, C,
                    table.key.shape[0] - 1, table.ec_count.shape[0],
                    sig_probe, int(audit)),
                 "accumulate")
    fold_batch.launches += 1
    return table


fold_batch.launches = 0


def empty_launch(B: int, device: torch.device, cooperative: bool) -> None:
    """An empty kernel on the grid ``fold_batch`` launches for B reads
    (cooperative, with one grid barrier, as with the audit on): the floor
    under its launch time. Counts nothing; for timing only."""
    warps = -(-B // 32)
    blocks = -(-warps // WARPS)
    fn = _build.function("seekmer_empty_launch", 1, 4)
    _build.check(fn(torch.cuda.current_stream(device).cuda_stream,
                    device.index, blocks, 32 * WARPS, int(cooperative)),
                 "empty_launch")
