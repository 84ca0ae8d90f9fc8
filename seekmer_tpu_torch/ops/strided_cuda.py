"""K7: strided mode's lookup, sampled probe + run-length gap fill, in one
kernel (``csrc/strided.cu``).

Replaces the XLA body of ``seekmer_tpu/ops/probe.py:493-585``
``lookup_ecs_strided``. The JAX form gathers the sampled columns, looks
them up with their run lengths, fills the gaps in whole-batch passes, and
sends the uncovered windows through a block-compacted dense pass under a
static cap with a ``while_loop`` over the residue. Here a warp owns tiles
of segments (a read, or one mate of a pair): it stages a tile's valid bytes
and sampled keys in shared memory with ``cp.async`` while it works on the
tile before, looks the valid sampled keys up in full rounds of K2's warp
routine (``csrc/lookup.cuh``), fills each window from the samples around
it, and looks up the windows that neither covers in the same launch, 32
keys a round. No cap, no count read back. CPU tensors take the plain
``probe.lookup_ecs_strided``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .probe import AUX_BITS, lookup_ecs_strided as _plain

MAX_P = 1024  # widest segment the kernel takes (K3's widest row)
WARPS = 8  # csrc/strided.cu kWarps: warps a block
MIN_BLOCKS = 4  # its launch bound: blocks an SM at <= 64 registers
QUEUE = 160  # its kQueue: tags a warp's queue holds
SMEM_SM = 200_704  # shared memory K7 takes of an SM: 196 KB of Hopper's
# 228, which leaves L1 60 KB (on an H100, K7 at config-2 shapes ran up to
# 11% slower with tiles that took the whole 228 KB, leaving 28 KB of L1)
SMEM_BLOCK = 232_448  # shared memory a block can use (227 KB)
BLOCK_RESERVED = 1024  # shared memory the card keeps back a block


class StridedPlan(NamedTuple):
    """How K7 cuts a batch of segments of P windows at stride s: S sampled
    columns a segment (0, s, 2s, ... below P, then P - 1 always); tiles of
    ``segs`` segments; ``blocks`` an SM, as many of 4 as the warps' shared
    memory lets the card hold. The rest is the carve of a warp's
    shared memory, in bytes from its start, which this plan owns
    (``csrc/strided.cu`` only checks that each part fits): two staging
    buffers of ``stage`` bytes (a tile's valid run from the 16-byte chunk
    holding its first byte, its sampled windows' hi at ``hi_at`` and lo at
    ``lo_at``), then the slots (a tile's sampled results) and the queue."""

    S: int
    segs: int
    blocks: int
    stage: int
    hi_at: int
    lo_at: int
    slot_at: int
    queue_at: int
    warp_bytes: int


def _carve(P: int, S: int, segs: int) -> tuple:
    """(stage, hi_at, lo_at, slot_at, queue_at, warp_bytes) for tiles of
    ``segs`` segments."""
    n = 4 * segs * S
    hi_at = (segs * P + 30) & ~15  # the 16-byte chunks a run of segs P
    lo_at = hi_at + n
    stage = (lo_at + n + 15) & ~15
    slot_at = 2 * stage
    queue_at = slot_at + n
    return stage, hi_at, lo_at, slot_at, queue_at, \
        (queue_at + 4 * QUEUE + 15) & ~15


def warp_budget(blocks: int) -> int:
    """Shared memory a warp may take so that ``blocks`` blocks fit an SM."""
    return (min(SMEM_BLOCK, SMEM_SM // blocks - BLOCK_RESERVED)
            // WARPS) & ~15


def _largest_tile(P: int, S: int) -> tuple:
    """(blocks an SM, segments a tile): the largest tile whose carve fits a
    warp's share of shared memory at the most blocks an SM, 4 down to 1;
    raises when one segment does not fit a block."""
    for blocks in range(MIN_BLOCKS, 0, -1):
        most = 0
        while _carve(P, S, most + 1)[-1] <= warp_budget(blocks):
            most += 1
        if most:
            return blocks, most
    raise ValueError(f"a segment of {P} windows with {S} sampled columns "
                     f"needs more shared memory than a block has")


def strided_plan(P: int, stride: int, n_seg: int, sms: int) -> StridedPlan:
    """K7's plan for ``n_seg`` segments of P windows at stride ``stride``
    on a card of ``sms`` SMs: the largest tile that fits a warp's share of
    shared memory at the most blocks an SM, but no larger than leaves
    every warp the card holds (:func:`resident_warps`) a tile (a larger
    tile leaves fewer partial rounds: a tile ends in one)."""
    if not 1 <= P <= MAX_P or stride < 2:
        raise ValueError(f"K7 takes segments of 1-{MAX_P} windows at "
                         f"strides of 2 and more, got P={P}, s={stride}")
    S = -(-P // stride) + 1
    blocks, most = _largest_tile(P, S)
    resident = resident_warps(sms, blocks)
    segs = max(1, min(most, n_seg // resident))
    return StridedPlan(S, segs, blocks, *_carve(P, S, segs))


def resident_warps(sms: int, blocks: int) -> int:
    """K7's warps a card of ``sms`` SMs holds at once at ``blocks`` blocks
    an SM: the plan's ``blocks`` is what its launch bound (4 blocks at <=
    64 registers) and its shared memory let an SM hold."""
    return sms * blocks * WARPS


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
    n_seg = B * segments
    if n_seg * P >= 1 << 31:
        raise ValueError(f"K7 takes fewer than 2^31 windows a call, got "
                         f"{n_seg * P}")
    plan = strided_plan(P, stride, n_seg, torch.cuda.get_device_properties(
        hi.device).multi_processor_count)
    vec4 = P % 4 == 0
    fn = _build.function("seekmer_strided_lookup", 7, 17)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                    table.data_ptr(), stash.data_ptr(), ec.data_ptr(),
                    _build.stream_of(hi), hi.device.index, n_seg, P,
                    stride, plan.S, plan.segs, main_slots // bucket,
                    stash_slots // bucket, bucket, AUX_BITS, int(vec4),
                    *plan[3:]),
                 "strided_lookup")
    lookup_ecs_strided.paths["vec4" if vec4 else "scalar"] += 1
    lookup_ecs_strided.launches += 1
    return ec


lookup_ecs_strided.launches = 0
# launches by fill path: 4 windows a lane (P % 4 == 0) or one
lookup_ecs_strided.paths = {"vec4": 0, "scalar": 0}
