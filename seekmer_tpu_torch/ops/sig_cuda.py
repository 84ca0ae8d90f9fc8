"""K3: per-read EC signatures in one kernel (``csrc/sig.cu``).

Replaces ``seekmer_tpu/ops/sig_pallas.py`` ``_sig_kernel`` with
``_bitonic_sort_rows`` (through ``read_signatures_pallas``). The TPU form
built its bitonic network from circular lane rolls and sorted twice; here
one warp sorts one read's row in shared memory and compacts the distinct
ids with a prefix sum, so one sort suffices. It is bounded by shared-memory
traffic of the sort, not by device memory.
"""

from __future__ import annotations

import torch

from ..map.signature import read_signatures as plain
from . import _build


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# Widest window axis the kernel takes, the widest the main path reaches: a
# paired row at max_read_len=512 has 2 x 488 windows, W = 1024. A block's
# 4 reads x W int32 of dynamic shared memory (16 KB) stay inside the 48 KB
# a launch gets without opting in to more.
MAX_W = 1024


def read_signatures(ecs: torch.Tensor, valid: torch.Tensor, max_ecs: int):
    """Per-read sorted distinct EC ids, capped.

    ecs int32[B, P] (-1 = miss), valid bool[B, P]; returns (sig int32[B, C]
    padded with SIG_PAD, mapped bool[B]) with mapped = 1 <= n_distinct <= C.
    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if ecs.device.type == "cpu":
        return plain(ecs, valid, max_ecs)
    B, P = ecs.shape
    C = max_ecs
    W = max(_next_pow2(max(P, C)), 32)
    if W > MAX_W:
        raise ValueError(f"window axis {P} exceeds the kernel's {MAX_W}")
    if ecs.dtype != torch.int32:
        raise ValueError("ecs must be int32")
    valid = valid.to(torch.bool)
    _build.require_cuda("read_signatures", ecs, valid)
    sig = torch.empty((B, C), dtype=torch.int32, device=ecs.device)
    mapped = torch.empty(B, dtype=torch.bool, device=ecs.device)
    fn = _build.function("seekmer_read_signatures", 5, 5)
    _build.check(fn(ecs.data_ptr(), valid.data_ptr(), sig.data_ptr(),
                    mapped.data_ptr(), _build.stream_of(ecs),
                    ecs.device.index, B, P, W, C),
                 "read_signatures")
    read_signatures.launches += 1
    return sig, mapped


read_signatures.launches = 0
