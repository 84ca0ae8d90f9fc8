"""The routing of the prefix-sharded index's lookup, plain PyTorch: what
R1 and R2 (``csrc/route.cu``, ``ops/route_cuda.py``) are held against.

Counterpart of the XLA code of ``seekmer_tpu/parallel/prefix_shard.py``
``routed_lookup``: the owner of a lane is the top ``log2(D)`` bits of its
main-table slot hash, lanes are ranked within their owner (a stable sort
by owner here, the JAX package's ``lax.sort`` + associative scan), the
lanes of round j, those ranked in ``[jK, (j+1)K)``, are scattered into the
(D, K) send slab, and the ECs that come back go to their lanes
(``unroute``). ``route_first`` ranks and writes round 0's slab, and lists
the lanes ranked K or more (the spill list); ``route_spill`` writes a
later round's slab from that list alone. Invalid lanes route nowhere.
"""

from __future__ import annotations

import torch

from .hash import hash_kmer


def owner_bits(n_owners: int) -> int:
    """log2 of the number of owners, which must be a power of two."""
    if n_owners < 1 or n_owners & (n_owners - 1):
        raise ValueError(f"the owners must be a power of two, got "
                         f"{n_owners}")
    return n_owners.bit_length() - 1


def _slab(hi, lo, lane, own, rank, n_owners: int, base: int, K: int):
    """(send_hi, send_lo, ret), each int32[D * K]: the listed lanes ranked
    in [base, base + K) at slot own * K + rank - base with their own index
    in ``ret``. Unfilled slots hold 0, 0 and -1 here (the kernels leave
    them unwritten)."""
    sel = (rank >= base) & (rank < base + K)
    lane = lane[sel].to(torch.int64)
    dest = own[sel].to(torch.int64) * K + rank[sel] - base
    send_hi = torch.zeros(n_owners * K, dtype=torch.int32, device=hi.device)
    send_lo = torch.zeros_like(send_hi)
    ret = torch.full_like(send_hi, -1)
    send_hi[dest] = hi[lane]
    send_lo[dest] = lo[lane]
    ret[dest] = lane.to(torch.int32)
    return send_hi, send_lo, ret


def route_first(hi, lo, valid, n_owners: int, K: int):
    """(send_hi, send_lo, ret, counts, spill) of flat lanes: round 0's
    slab (each int32[D * K]) of the lanes ranked below K within their
    owner (their order in the batch here), the lanes each owner gets
    (int32[D]), and the spill list, int32[3, S]: the index, owner and rank
    of each lane ranked K or more, in lane order;
    S = sum_d max(counts[d] - K, 0)."""
    b = owner_bits(n_owners)
    own = (hash_kmer(hi, lo) >> (32 - b) if b
           else torch.zeros(hi.shape, dtype=torch.int64, device=hi.device))
    own = torch.where(valid.to(torch.bool), own, n_owners)
    counts = torch.bincount(own, minlength=n_owners + 1)
    order = torch.sort(own, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(own)
    rank[order] = torch.arange(own.numel(), device=own.device) - starts[
        own[order]]
    mine = torch.nonzero(own < n_owners).squeeze(1)
    own, rank = own[mine], rank[mine]
    slab = _slab(hi, lo, mine, own, rank, n_owners, 0, K)
    out = rank >= K
    spill = torch.stack([mine[out], own[out], rank[out]]).to(torch.int32)
    return (*slab, counts[:n_owners].to(torch.int32), spill)


def route_spill(hi, lo, spill, n_spill: int, n_owners: int, base: int,
                K: int):
    """Round ``base // K``'s slab (send_hi, send_lo, ret) from the first
    ``n_spill`` entries of the spill list: those ranked in
    [base, base + K)."""
    lane, own, rank = spill[:, :n_spill].to(torch.int64)
    return _slab(hi, lo, lane, own, rank, n_owners, base, K)


def filled(counts, base: int, K: int) -> torch.Tensor:
    """bool[D * K]: the slots of a round's slab that hold a lane, slot j
    of owner d when j < counts[d] - base."""
    n = (counts.to(torch.int64) - base).clamp(0, K)
    j = torch.arange(K, device=counts.device)
    return (j[None, :] < n[:, None]).reshape(-1)


def unroute(ec_back, ret, counts, base: int, K: int, ecs):
    """Write the returned ECs of a round's filled slots to their lanes:
    ``ecs[ret[s]] = ec_back[s]``; returns ``ecs``, written in place."""
    f = filled(counts, base, K)
    ecs[ret[f].to(torch.int64)] = ec_back[f]
    return ecs
