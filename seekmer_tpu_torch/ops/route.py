"""The routing of the prefix-sharded index's lookup, plain PyTorch: what
R1 and R2 (``csrc/route.cu``, ``ops/route_cuda.py``) are held against.

Counterpart of the XLA code of ``seekmer_tpu/parallel/prefix_shard.py``
``routed_lookup``: the owner of a lane is the top ``log2(D)`` bits of its
main-table slot hash, lanes are ranked within their owner
(``route_rank``; a stable sort by owner here, the JAX package's
``lax.sort`` + associative scan), a round's lanes, those ranked in
``[base, base + K)``, are scattered into the (D, K) send slab
(``dispatch``), and the ECs that come back go to their lanes
(``unroute``). Invalid lanes take owner D and rank -1 and route nowhere.
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


def route_rank(hi, lo, valid, n_owners: int):
    """(owner int32[N], rank int32[N], counts int32[D]) of flat lanes: each
    valid lane's owner (the top log2(D) bits of its slot hash) and its
    rank among the lanes of that owner (their order in the batch here),
    the lanes each owner gets; invalid lanes have owner D and rank -1."""
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
    rank = torch.where(own < n_owners, rank, -1)
    return (own.to(torch.int32), rank.to(torch.int32),
            counts[:n_owners].to(torch.int32))


def dispatch(hi, lo, owner, rank, n_owners: int, base: int, K: int):
    """A round's send slab: (send_hi, send_lo, ret), each int32[D * K];
    the lane of owner d ranked r in [base, base + K) goes to slot
    d * K + r - base with its own index in ``ret``. Unfilled slots hold
    0, 0 and -1 here (the kernel leaves them unwritten)."""
    D = n_owners
    sel = (owner < D) & (rank >= base) & (rank < base + K)
    dest = (owner[sel].to(torch.int64) * K + rank[sel] - base)
    send_hi = torch.zeros(D * K, dtype=torch.int32, device=hi.device)
    send_lo = torch.zeros_like(send_hi)
    ret = torch.full_like(send_hi, -1)
    send_hi[dest] = hi[sel]
    send_lo[dest] = lo[sel]
    ret[dest] = torch.nonzero(sel).squeeze(1).to(torch.int32)
    return send_hi, send_lo, ret


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
