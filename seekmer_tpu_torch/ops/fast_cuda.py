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

import torch

from . import _build, pack_cuda, probe_cuda, sig_cuda
from .probe import AUX_BITS, FastSteps
from .probe import merge_staging as plain_merge
from .probe import sample_classify as plain_sample
from .probe import two_phase_signatures as _two_phase


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
    fn = _build.function("seekmer_sample_classify", 15, 10)
    _build.check(fn(*(t.data_ptr() for t in mates[0]),
                    *(t.data_ptr() for t in mates[-1]), table.data_ptr(),
                    stash.data_ptr(), single.data_ptr(), slot.data_ptr(),
                    count.data_ptr(), *(t.data_ptr() for t in units),
                    _build.stream_of(single), dev.index, B, n_seg, L, k,
                    max(stride, 2), main_slots // bucket,
                    stash_slots // bucket, bucket, AUX_BITS),
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
