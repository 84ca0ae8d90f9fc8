"""K3: per-read EC signatures in one kernel (``csrc/sig.cu``).

Replaces ``seekmer_tpu/ops/sig_pallas.py`` ``_sig_kernel`` with
``_bitonic_sort_rows`` (through ``read_signatures_pallas``). The TPU form
sorted the whole padded row twice with a network of lane rolls. Here one
warp owns a read and keeps its windows in registers; it sorts only the
heads of the row's runs of equal EC ids (at most 32 on nearly every read,
one to a lane, with a shuffle network), and sorts the whole row in
registers on the rare read with more. It is bounded by the bytes of its
inputs. With ``segments`` = 2 (fusion mode) the warp does the same for
each half of the row in turn and writes the two signatures side by side.
Given a counter, the warp of each complex read (more than C distinct ids
in a segment) adds 1 to it; without one the kernel counts nothing.
"""

from __future__ import annotations

import torch

from ..map.signature import read_signatures as plain
from . import _build

# Widest window axis the kernel takes, the widest the main path reaches: a
# paired row at max_read_len=512 has 2 x 488 windows. A lane holds up to
# MAX_W / 32 windows in registers.
MAX_W = 1024


def read_signatures(ecs: torch.Tensor, valid: torch.Tensor, max_ecs: int,
                    segments: int = 1, n_complex: torch.Tensor | None = None):
    """Per-read sorted distinct EC ids, capped, one signature a segment.

    ecs int32[B, W] (-1 = miss), valid bool[B, W], W = segments x P;
    returns (sig int32[B, segments x C] padded with SIG_PAD, segment g's
    signature in columns [g C, g C + C), and mapped bool[B], the AND over
    the segments of 1 <= n_distinct <= C). ``segments`` = 2 is fusion
    mode's pair of mates. ``n_complex``, an int32 scalar on the same
    device, gains the reads with more than C distinct ids in a segment
    when given. CPU tensors take the plain version; CUDA tensors the
    kernel.
    """
    if ecs.device.type == "cpu":
        return plain(ecs, valid, max_ecs, segments, n_complex)
    B, W = ecs.shape
    C = max_ecs
    if segments not in (1, 2) or W % segments:
        raise ValueError(f"the kernel takes 1 or 2 equal segments a row, "
                         f"got {segments} over a window axis of {W}")
    P = W // segments
    if P > MAX_W:
        raise ValueError(f"window axis {P} exceeds the kernel's {MAX_W}")
    if C < 1:
        raise ValueError("max_ecs must be at least 1")
    if ecs.dtype != torch.int32:
        raise ValueError("ecs must be int32")
    if valid.dtype != torch.bool:
        valid = valid.to(torch.bool)
    counter = () if n_complex is None else (n_complex,)
    if n_complex is not None and (n_complex.dtype != torch.int32
                                  or n_complex.numel() != 1):
        raise ValueError("n_complex must be one int32 element")
    _build.require_cuda("read_signatures", ecs, valid, *counter)
    sig = torch.empty((B, segments * C), dtype=torch.int32,
                      device=ecs.device)
    mapped = torch.empty(B, dtype=torch.bool, device=ecs.device)
    fn = _build.function("seekmer_read_signatures", 6, 5)
    _build.check(fn(ecs.data_ptr(), valid.data_ptr(), sig.data_ptr(),
                    mapped.data_ptr(),
                    None if n_complex is None else n_complex.data_ptr(),
                    _build.stream_of(ecs),
                    ecs.device.index, B, P, C, segments),
                 "read_signatures")
    read_signatures.launches += 1
    return sig, mapped


read_signatures.launches = 0
