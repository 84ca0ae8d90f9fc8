"""Fast mode's kernels: K5, sample + probe + classify (``csrc/sample.cu``),
and K6, the merge (``csrc/merge.cu``).

They replace the XLA code of ``seekmer_tpu/ops/probe.py``
``two_phase_signatures``: K5 its phase 1 and the choice of the units to
re-probe (``:339-407``), K6 its merge (``:481-490``). Between them the
needy units go once through K1, K2 and K3 (``KERNELS``); the JAX package's
capped fallback rounds and residual ``while_loop`` have no counterpart.
CPU tensors take the plain versions of ``ops/probe.py``; CUDA tensors the
kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, pack_cuda, probe_cuda, sig_cuda
from .probe import AUX_BITS, FastSteps, sample_columns
from .probe import merge_staging as plain_merge
from .probe import sample_classify as plain_sample
from .probe import two_phase_signatures as _two_phase

SAMPLED_LANES = 256  # sampled lanes a K5 warp aims at: 8 rounds of 32
MAX_WARPS = 8  # K5's warps a block
SMEM_BLOCK = 232_448  # shared memory a block can use on Hopper (227 KB)


class SamplePlan(NamedTuple):
    """How K5 cuts a batch: S sampled columns a segment; a warp's tile of
    ``reads`` whole reads (at most 32 segments, one a lane for the
    reduce); ``keys`` slots for their sampled lanes (a multiple of 32: one
    validity ballot each 32, ``keys / 32`` of them, more than 8 only when
    one read's segments have more than 256 sampled columns between them);
    ``warp_bytes`` of shared memory a warp; ``warps`` a block, as many of 8
    as fit. The rest is the carve of a warp's shared memory, which this
    plan owns (``csrc/sample.cu`` only checks that each part fits), in
    bytes from its start: mate g's staged 2-bit span at ``g * mate_at``
    and its bad-bitmask span at ``g * mate_at + bad_at``, then the keys
    (8 bytes each), the ballots (4 bytes each 32 keys) and the needy
    segments (32 bytes)."""

    S: int
    reads: int
    keys: int
    warp_bytes: int
    warps: int
    bad_at: int
    mate_at: int
    keys_at: int
    bits_at: int
    useg_at: int


def _span_bytes(n: int) -> int:
    """Shared memory a staged row span of n bytes needs: the kernel copies
    it from the 16-byte chunk that holds its first byte and reads 16 bytes
    from an 8-byte word at or before its last."""
    return ((n + 30) & ~15) + 16


def sample_plan(L: int, k: int, stride: int, n_seg: int) -> SamplePlan:
    """K5's plan for segments of padded length L at stride ``stride``;
    raises when one read's rows and keys do not fit a block's shared
    memory."""
    S = len(sample_columns(L - k + 1, stride))
    per_read = n_seg * S
    reads = max(1, min(32 // n_seg, SAMPLED_LANES // per_read))
    keys = -(-reads * per_read // 32) * 32
    bad_at = _span_bytes(reads * ((L + 3) // 4))
    mate_at = bad_at + _span_bytes(reads * ((L + 7) // 8))
    keys_at = n_seg * mate_at
    bits_at = keys_at + 8 * keys
    useg_at = bits_at + keys // 8
    warp_bytes = (useg_at + 32 + 15) & ~15
    warps = min(MAX_WARPS, SMEM_BLOCK // warp_bytes)
    if warps < 1:
        raise ValueError(f"padded length {L} at stride {stride}: a read's "
                         f"rows and keys take {warp_bytes} bytes of shared "
                         f"memory, more than a block has ({SMEM_BLOCK})")
    return SamplePlan(S, reads, keys, warp_bytes, warps, bad_at, mate_at,
                      keys_at, bits_at, useg_at)


def sample_classify(mates, L: int, k: int, stride: int, table,
                    main_slots: int, stash, stash_slots: int, bucket: int):
    """Phase 1 of fast mode, as ``probe.sample_classify``: returns (single,
    slot, units). On the card the units' order is the order in which K5's
    warps took their slots, which varies from run to run; slot names each
    unit's row. The host reads the unit count back once a call to size the
    units and phase 2's launches: the JAX package's residual loop waits on
    the same fact, read on the device."""
    if mates[0][0].device.type == "cpu":
        return plain_sample(mates, L, k, stride, table, main_slots, stash,
                            stash_slots, bucket)
    single, slot, count, units = launch_sample(mates, L, k, stride, table,
                                               main_slots, stash,
                                               stash_slots, bucket)
    nu = int(count.item())
    return single, slot, tuple(t[:nu] for t in units)


def launch_sample(mates, L: int, k: int, stride: int, table,
                  main_slots: int, stash, stash_slots: int, bucket: int):
    """K5's launch alone, with no readback: (single, slot, count int32[1],
    units sized for every unit, of which the first ``count`` are
    written)."""
    n_seg = len(mates)
    if n_seg not in (1, 2):
        raise ValueError(f"fast mode takes 1 or 2 segments, got {n_seg}")
    if not 1 <= k <= 29 or L < k:
        raise ValueError(f"padded length {L}, k={k}: need 1 <= k <= 29, "
                         f"k <= L")
    if not 1 <= bucket <= 32 or bucket & (bucket - 1):
        raise ValueError(f"the lookup takes buckets of a power of two <= 32 "
                         f"slots, got {bucket}")
    if table.shape[1] != 4 * bucket or stash.shape[1] != 4 * bucket:
        raise ValueError("tables must be in the (n_buckets, 4*bucket) slab "
                         "layout (probe.device_table_layout)")
    B = mates[0][0].shape[0]
    Sp, Sb = (L + 3) // 4, (L + 7) // 8
    mates = [(p, bd, ln.to(torch.int32)) for p, bd, ln in mates]
    for p, bd, ln in mates:
        if p.dtype != torch.uint8 or bd.dtype != torch.uint8:
            raise ValueError("packed and bad must be uint8")
        if p.shape != (B, Sp) or bd.shape != (B, Sb) or ln.shape != (B,):
            raise ValueError(f"mate shapes {tuple(p.shape)}, "
                             f"{tuple(bd.shape)}, {tuple(ln.shape)} do not "
                             f"fit B={B}, L={L}")
    dev = mates[0][0].device
    single = torch.empty((B, n_seg), dtype=torch.int32, device=dev)
    slot = torch.empty_like(single)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    units = (torch.empty((B * n_seg, Sp), dtype=torch.uint8, device=dev),
             torch.empty((B * n_seg, Sb), dtype=torch.uint8, device=dev),
             torch.empty(B * n_seg, dtype=torch.int32, device=dev))
    _build.require_cuda("sample_classify", *(t for m in mates for t in m),
                        table, stash, single, slot, count, *units)
    if table.data_ptr() % 16 or stash.data_ptr() % 16:
        raise ValueError("tables must start on a 16-byte boundary (the "
                         "kernel reads their rows as 16-byte vectors)")
    plan = sample_plan(L, k, stride, n_seg)
    fn = _build.function("seekmer_sample_classify", 15, 20)
    _build.check(fn(*(t.data_ptr() for t in mates[0]),
                    *(t.data_ptr() for t in mates[-1]), table.data_ptr(),
                    stash.data_ptr(), single.data_ptr(), slot.data_ptr(),
                    count.data_ptr(), *(t.data_ptr() for t in units),
                    _build.stream_of(single), dev.index, B, n_seg, L, k,
                    max(stride, 2), main_slots // bucket,
                    stash_slots // bucket, bucket, AUX_BITS, *plan),
                 "sample_classify")
    sample_classify.launches += 1
    return single, slot, count, units


sample_classify.launches = 0


def merge_staging(single, slot, sig_d, mapped_d, max_ecs: int):
    """Each read's (sig int32[B, C], mapped bool[B]) from its segments'
    contributions, as ``probe.merge_staging``."""
    if single.device.type == "cpu":
        return plain_merge(single, slot, sig_d, mapped_d, max_ecs)
    B, n_seg = single.shape
    C = max_ecs
    if n_seg not in (1, 2) or slot.shape != single.shape:
        raise ValueError(f"single/slot shapes {tuple(single.shape)}, "
                         f"{tuple(slot.shape)}: need (B, 1 or 2), equal")
    if sig_d.dim() != 2 or sig_d.shape[1] != C \
            or mapped_d.shape != sig_d.shape[:1]:
        raise ValueError(f"sig_d {tuple(sig_d.shape)}, mapped_d "
                         f"{tuple(mapped_d.shape)} do not fit C={C}")
    if (single.dtype != torch.int32 or slot.dtype != torch.int32
            or sig_d.dtype != torch.int32 or mapped_d.dtype != torch.bool):
        raise ValueError("single, slot and sig_d must be int32, mapped_d "
                         "bool")
    _build.require_cuda("merge_staging", single, slot, sig_d, mapped_d)
    sig = torch.empty((B, C), dtype=torch.int32, device=single.device)
    mapped = torch.empty(B, dtype=torch.bool, device=single.device)
    fn = _build.function("seekmer_merge_staging", 7, 4)
    _build.check(fn(single.data_ptr(), slot.data_ptr(), sig_d.data_ptr(),
                    mapped_d.data_ptr(), sig.data_ptr(), mapped.data_ptr(),
                    _build.stream_of(single), single.device.index, B, n_seg,
                    C),
                 "merge_staging")
    merge_staging.launches += 1
    return sig, mapped


merge_staging.launches = 0


KERNELS = FastSteps(sample_classify, pack_cuda.pack_canonical_2bit,
                    probe_cuda.lookup_ecs, sig_cuda.read_signatures,
                    merge_staging)


def two_phase_signatures(mates, L: int, k: int, stride: int, max_ecs: int,
                         table, main_slots: int, stash, stash_slots: int,
                         bucket: int):
    """Fast mode's (sig, mapped) through K5, then K1, K2 and K3 on the
    needy units (none when there are none), then K6; on CPU tensors every
    step's plain version, which is ``probe.two_phase_signatures``."""
    return _two_phase(mates, L, k, stride, max_ecs, table, main_slots, stash,
                      stash_slots, bucket, steps=KERNELS)
