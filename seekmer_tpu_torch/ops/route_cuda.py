"""R1 and R2, the routing kernels of the prefix-sharded index
(``csrc/route.cu``): R1's ``route_first`` (owner and rank of every lane,
per-owner counts, round 0's (D, K) send slab and the spill list of the
lanes ranked K or more, in one pass, once a lookup) and ``route_spill``
(a later round's slab from the spill list), R2's ``unroute`` (a round's
returned ECs to their lanes). They replace the XLA of
``seekmer_tpu/parallel/prefix_shard.py`` ``routed_lookup`` (``:205-233``
and ``:247-249``). CPU tensors take the plain versions of
``ops/route.py``; CUDA tensors the kernels.

All three are bound by the bytes they move. R2 touches only a round's
filled slots: a block a chunk of 2,048 slots of one owner's run, which
reads the owner's count once and exits when its chunk is past the run;
each thread loads 8 slots' return index and EC, evict-first so that L2
keeps ``ecs``, before it stores any, and no thread divides (a slot's
place in its run is 32-bit, hence ``MAX_UNROUTE_K``).
"""

from __future__ import annotations

import torch

from . import _build
from . import route as plain
from .route import owner_bits

MAX_OWNERS = 64  # R1's per-owner counters live in a block's shared memory
MAX_UNROUTE_K = 2**31 - 1 - 2048  # R2's slot place plus its chunk in an int


def route_first(hi, lo, valid, n_owners: int, K: int):
    """(send_hi, send_lo, ret, counts, spill) of flat lanes, as
    ``route.route_first`` but for the order of the ranks within an owner,
    which on the card varies from run to run, and so which lanes spill.
    On the card the slab's unfilled slots are left unwritten, and the
    spill list is int32[3, max(N - K, 0)], of which the first
    sum_d max(counts[d] - K, 0) columns are written."""
    if hi.device.type == "cpu":
        return plain.route_first(hi, lo, valid, n_owners, K)
    bits = owner_bits(n_owners)
    if n_owners > MAX_OWNERS:
        raise ValueError(f"R1 takes at most {MAX_OWNERS} owners, got "
                         f"{n_owners}")
    if K < 0:
        raise ValueError(f"routing capacity {K} < 0")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise ValueError("hi and lo must be int32")
    if not hi.numel() == lo.numel() == valid.numel():
        raise ValueError("hi, lo and valid must hold as many lanes")
    v = valid.to(torch.bool)
    _build.require_cuda("route_first", hi, lo, v)
    N = hi.numel()
    dev = hi.device
    send_hi = torch.empty(n_owners * K, dtype=torch.int32, device=dev)
    send_lo = torch.empty_like(send_hi)
    ret = torch.empty_like(send_hi)
    # the spill list's length in the last entry; at most N - K lanes spill
    counts = torch.empty(n_owners + 1, dtype=torch.int32, device=dev)
    cap = max(N - K, 0)
    spill = torch.empty((3, cap), dtype=torch.int32, device=dev)
    fn = _build.function("seekmer_route_first", 9, 6)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), v.data_ptr(),
                    send_hi.data_ptr(), send_lo.data_ptr(), ret.data_ptr(),
                    counts.data_ptr(), spill.data_ptr(), _build.stream_of(hi),
                    dev.index, N, n_owners, bits, K, cap),
                 "route_first")
    route_first.launches += N > 0  # an empty batch only zeroes the counts
    return send_hi, send_lo, ret, counts[:n_owners], spill


route_first.launches = 0


def route_spill(hi, lo, spill, n_spill: int, n_owners: int, base: int,
                K: int):
    """Round ``base // K``'s slab (send_hi, send_lo, ret), each
    int32[D * K], from the first ``n_spill`` entries of ``route_first``'s
    spill list, as ``route.route_spill``; on the card the slots past each
    owner's count in this round are left unwritten."""
    if hi.device.type == "cpu":
        return plain.route_spill(hi, lo, spill, n_spill, n_owners, base, K)
    if spill.dim() != 2 or spill.shape[0] != 3 or n_spill > spill.shape[1]:
        raise ValueError(f"a spill list of {tuple(spill.shape)} for "
                         f"{n_spill} entries")
    _build.require_cuda("route_spill", hi, lo, spill)
    send_hi = torch.empty(n_owners * K, dtype=torch.int32, device=hi.device)
    send_lo = torch.empty_like(send_hi)
    ret = torch.empty_like(send_hi)
    fn = _build.function("seekmer_route_spill", 7, 5)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), spill.data_ptr(),
                    send_hi.data_ptr(), send_lo.data_ptr(), ret.data_ptr(),
                    _build.stream_of(hi), hi.device.index, n_spill,
                    spill.shape[1], base, K),
                 "route_spill")
    route_spill.launches += n_spill > 0
    return send_hi, send_lo, ret


route_spill.launches = 0


def unroute(ec_back, ret, counts, base: int, K: int, ecs):
    """Write a round's returned ECs to their lanes in ``ecs``, as
    ``route.unroute``: ``ecs[ret[s]] = ec_back[s]`` for slot s = d * K + j
    of every owner d with j < counts[d] - base; no other lane is touched
    and no other slot read."""
    if ec_back.device.type == "cpu":
        return plain.unroute(ec_back, ret, counts, base, K, ecs)
    D = counts.numel()
    if ec_back.numel() != D * K or ret.numel() != D * K:
        raise ValueError(f"slab of {ec_back.numel()} / {ret.numel()} slots, "
                         f"expected {D} x {K}")
    if D > MAX_OWNERS or K > MAX_UNROUTE_K:
        raise ValueError(f"R2 takes at most {MAX_OWNERS} owners and "
                         f"{MAX_UNROUTE_K} slots an owner, got {D} x {K}")
    if not (ec_back.dtype == ret.dtype == counts.dtype == ecs.dtype
            == torch.int32):
        raise ValueError("ec_back, ret, counts and ecs must be int32")
    _build.require_cuda("unroute", ec_back, ret, counts, ecs)
    fn = _build.function("seekmer_route_unroute", 5, 4)
    _build.check(fn(ec_back.data_ptr(), ret.data_ptr(), counts.data_ptr(),
                    ecs.data_ptr(), _build.stream_of(ecs), ecs.device.index,
                    D, base, K),
                 "route_unroute")
    unroute.launches += D * K > 0
    return ecs


unroute.launches = 0
