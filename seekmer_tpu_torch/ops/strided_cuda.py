"""K7: strided mode's lookup, sampled probe + run-length gap fill, in one
kernel (``csrc/strided.cu``).

Replaces the XLA body of ``seekmer_tpu/ops/probe.py:493-585``
``lookup_ecs_strided``. The JAX form gathers the sampled columns, looks
them up with their run lengths, fills the gaps in whole-batch passes, and
sends the uncovered windows through a block-compacted dense pass under a
static cap with a ``while_loop`` over the residue. Here a warp owns a tile
of segments (a read, or one mate of a pair): it looks up their valid
sampled keys in full rounds of K2's warp routine (``csrc/lookup.cuh``),
fills each window from the samples around it, and looks up the windows
that neither covers in the same launch, 32 keys a round. No cap, no count
read back. CPU tensors take the plain ``probe.lookup_ecs_strided``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .probe import AUX_BITS, lookup_ecs_strided as _plain

MAX_P = 1024  # widest segment the kernel takes (K3's widest row)
TILE_SAMPLES = 256  # sampled lanes a warp's tile aims at: 8 rounds of 32
MAX_SLOTS = 520  # csrc/strided.cu kMaxSlots: a tile's samples


class StridedPlan(NamedTuple):
    """S sampled columns a segment of P windows at stride s (0, s, 2s, ...
    below P, then P - 1 always), and ``segs`` segments a warp's tile: as
    many as keep the tile's sampled lanes near 256, at least 1, at most 32.
    """

    S: int
    segs: int


def strided_plan(P: int, stride: int) -> StridedPlan:
    S = -(-P // stride) + 1
    return StridedPlan(S, max(1, min(32, TILE_SAMPLES // S)))


def plain(hi, lo, valid, table, main_slots: int, stash, stash_slots: int,
          bucket: int, stride: int, segments: int = 1):
    """The plain version over ``segments`` equal segments a row: each one
    through ``probe.lookup_ecs_strided``, as rows of their own."""
    B, W = hi.shape
    if W % segments:
        raise ValueError(f"row width {W} is not {segments} equal segments")
    P = W // segments
    return _plain(*(x.reshape(B * segments, P) for x in (hi, lo, valid)),
                  table, main_slots, stash, stash_slots, bucket,
                  stride).reshape(B, W)


def lookup_ecs_strided(hi, lo, valid, table, main_slots: int, stash,
                       stash_slots: int, bucket: int, stride: int,
                       segments: int = 1):
    """(hi, lo, valid) [B, W] of ``segments`` segments of P = W / segments
    windows a row (a pair's two mates: 2) -> ec int32 [B, W], each segment
    strided on its own, so that coverage never crosses a segment's end.
    Equal to ``probe.lookup_ecs_strided`` on each segment. CPU tensors take
    the plain version; CUDA tensors K7, which takes strides of 2 and more
    (the map step probes every window through K2 at stride 1)."""
    if hi.device.type == "cpu":
        return plain(hi, lo, valid, table, main_slots, stash, stash_slots,
                     bucket, stride, segments)
    if stride < 2:
        raise ValueError(f"K7 takes strides of 2 and more, got {stride}")
    if hi.dim() != 2 or hi.shape != lo.shape or hi.shape != valid.shape:
        raise ValueError("hi, lo and valid must be [B, W] of one shape")
    B, W = hi.shape
    if segments < 1 or W % segments:
        raise ValueError(f"row width {W} is not {segments} equal segments")
    P = W // segments
    if P > MAX_P:
        raise ValueError(f"segments of {P} windows exceed the kernel's "
                         f"{MAX_P}")
    if not 1 <= bucket <= 32 or bucket & (bucket - 1):
        raise ValueError(f"the lookup takes buckets of a power of two <= 32 "
                         f"slots, got {bucket}")
    if table.shape[1] != 4 * bucket or stash.shape[1] != 4 * bucket:
        raise ValueError("tables must be in the (n_buckets, 4*bucket) slab "
                         "layout (probe.device_table_layout)")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise ValueError("hi and lo must be int32")
    if valid.dtype != torch.bool:
        valid = valid.to(torch.bool)
    ec = torch.empty((B, W), dtype=torch.int32, device=hi.device)
    _build.require_cuda("lookup_ecs_strided", hi, lo, valid, table, stash, ec)
    if table.data_ptr() % 16 or stash.data_ptr() % 16:
        raise ValueError("tables must start on a 16-byte boundary (the "
                         "kernel reads their rows as 16-byte vectors)")
    if B * W == 0:
        return ec
    plan = strided_plan(P, stride)
    fn = _build.function("seekmer_strided_lookup", 7, 10)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                    table.data_ptr(), stash.data_ptr(), ec.data_ptr(),
                    _build.stream_of(hi), hi.device.index, B * segments, P,
                    stride, plan.S, plan.segs, main_slots // bucket,
                    stash_slots // bucket, bucket, AUX_BITS),
                 "strided_lookup")
    lookup_ecs_strided.launches += 1
    return ec


lookup_ecs_strided.launches = 0
