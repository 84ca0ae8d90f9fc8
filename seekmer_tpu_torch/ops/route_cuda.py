"""R1 and R2, the routing kernels of the prefix-sharded index
(``csrc/route.cu``): R1's ``route_rank`` (owner, rank within the owner and
per-owner counts of every lane, once a lookup) and ``dispatch`` (a round's
(D, K) send slab), R2's ``unroute`` (a round's returned ECs to their
lanes). They replace the XLA of ``seekmer_tpu/parallel/prefix_shard.py``
``routed_lookup`` (``:205-233`` and ``:247-249``). CPU tensors take the
plain versions of ``ops/route.py``; CUDA tensors the kernels.
"""

from __future__ import annotations

import torch

from . import _build
from . import route as plain
from .route import owner_bits

MAX_OWNERS = 64  # R1's per-owner counters live in a block's shared memory


def route_rank(hi, lo, valid, n_owners: int):
    """(owner int32[N], rank int32[N], counts int32[D]) of flat lanes, as
    ``route.route_rank`` but for the order of the ranks within an owner,
    which on the card varies from run to run."""
    if hi.device.type == "cpu":
        return plain.route_rank(hi, lo, valid, n_owners)
    bits = owner_bits(n_owners)
    if n_owners > MAX_OWNERS:
        raise ValueError(f"R1 takes at most {MAX_OWNERS} owners, got "
                         f"{n_owners}")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise ValueError("hi and lo must be int32")
    if not hi.numel() == lo.numel() == valid.numel():
        raise ValueError("hi, lo and valid must hold as many lanes")
    v = valid.to(torch.bool)
    _build.require_cuda("route_rank", hi, lo, v)
    N = hi.numel()
    owner = torch.empty(N, dtype=torch.int32, device=hi.device)
    rank = torch.empty_like(owner)
    counts = torch.empty(n_owners, dtype=torch.int32, device=hi.device)
    fn = _build.function("seekmer_route_rank", 7, 4)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), v.data_ptr(),
                    owner.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                    _build.stream_of(hi), hi.device.index, N, n_owners,
                    bits),
                 "route_rank")
    route_rank.launches += N > 0  # an empty batch only zeroes the counts
    return owner, rank, counts


route_rank.launches = 0


def dispatch(hi, lo, owner, rank, n_owners: int, base: int, K: int):
    """A round's send slab (send_hi, send_lo, ret), each int32[D * K], as
    ``route.dispatch``; on the card the slots past each owner's count in
    this round are left unwritten."""
    if hi.device.type == "cpu":
        return plain.dispatch(hi, lo, owner, rank, n_owners, base, K)
    _build.require_cuda("dispatch", hi, lo, owner, rank)
    N = hi.numel()
    if not lo.numel() == owner.numel() == rank.numel() == N:
        raise ValueError("hi, lo, owner and rank must hold as many lanes")
    send_hi = torch.empty(n_owners * K, dtype=torch.int32, device=hi.device)
    send_lo = torch.empty_like(send_hi)
    ret = torch.empty_like(send_hi)
    fn = _build.function("seekmer_route_dispatch", 8, 5)
    _build.check(fn(hi.data_ptr(), lo.data_ptr(), owner.data_ptr(),
                    rank.data_ptr(), send_hi.data_ptr(), send_lo.data_ptr(),
                    ret.data_ptr(), _build.stream_of(hi), hi.device.index, N,
                    n_owners, base, K),
                 "route_dispatch")
    dispatch.launches += N > 0
    return send_hi, send_lo, ret


dispatch.launches = 0


def unroute(ec_back, ret, counts, base: int, K: int, ecs):
    """Write a round's returned ECs to their lanes in ``ecs``, as
    ``route.unroute``."""
    if ec_back.device.type == "cpu":
        return plain.unroute(ec_back, ret, counts, base, K, ecs)
    D = counts.numel()
    if ec_back.numel() != D * K or ret.numel() != D * K:
        raise ValueError(f"slab of {ec_back.numel()} / {ret.numel()} slots, "
                         f"expected {D} x {K}")
    _build.require_cuda("unroute", ec_back, ret, counts, ecs)
    fn = _build.function("seekmer_route_unroute", 5, 4)
    _build.check(fn(ec_back.data_ptr(), ret.data_ptr(), counts.data_ptr(),
                    ecs.data_ptr(), _build.stream_of(ecs), ecs.device.index,
                    D, base, K),
                 "route_unroute")
    unroute.launches += D * K > 0
    return ecs


unroute.launches = 0
