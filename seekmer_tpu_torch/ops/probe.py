"""Bucketized k-mer lookup, plain PyTorch.

Counterpart of ``seekmer_tpu/ops/probe.py`` ``_bucket_lookup``,
``lookup_ecs_aux`` and ``lookup_ecs``. These run on CPU tensors and are
what the lookup kernel (``ops/probe_cuda.py``) is held against.

The JAX ``_lookup_flat`` block-compacts the rare lanes that must consult
the stash into capped rounds under a ``while_loop``, so the second gather
costs O(needy blocks) under XLA's static shapes. The plain form here drops
that: a masked second lookup of the stash over all lanes computes the same
result.

``device_table_layout`` and the ``AUX_*``/``MAX_EC_ID`` constants are
copied from ``seekmer_tpu/ops/probe.py`` (lines 39-75): that module imports
JAX at the top, so the port cannot import them from there.
"""

from __future__ import annotations

import numpy as np
import torch

from .hash import hash_kmer, hash_kmer_stash

EMPTY = -1
MISS = -1

# ec and aux (EC run length, <= 127) share one int32 lane:
# ecaux = ec << AUX_BITS | aux, -1 for empty slots.
AUX_BITS = 7
AUX_MASK = (1 << AUX_BITS) - 1
MAX_EC_ID = (1 << (31 - AUX_BITS)) - 1

# Lanes per pass of the plain lookup: bounds its gathered-rows transient
# (3 * bucket int32 per lane) when it runs at a full batch's size.
_PLAIN_CHUNK = 1 << 20


def device_table_layout(table, bucket: int):
    """Host (S, 4) rows [hi, lo, ec, aux] -> (n_buckets, 4*bucket) slab
    rows ``[hi x G | lo x G | ecaux x G | meta x G]``; meta broadcasts the
    bucket-full flag. Copy of ``seekmer_tpu.ops.probe.device_table_layout``.
    """
    S = table.shape[0]
    rows = np.asarray(table).reshape(S // bucket, bucket, 4)
    hi, lo, ec, aux = (rows[:, :, i] for i in range(4))
    occ = hi != EMPTY
    if occ.any() and int(ec[occ].max()) > MAX_EC_ID:
        raise ValueError(
            f"EC id {int(ec[occ].max())} exceeds the packed-lane limit "
            f"{MAX_EC_ID} (ecaux = ec << {AUX_BITS} | aux)")
    ecaux = np.where(
        occ, (ec << AUX_BITS) | np.clip(aux, 0, AUX_MASK), -1
    ).astype(np.int32)
    meta = np.broadcast_to(
        occ.all(axis=1)[:, None], hi.shape).astype(np.int32)
    return np.concatenate(
        [hi, lo, ecaux, meta], axis=1).astype(np.int32)


def _bucket_lookup(hi, lo, table, slots: int, bucket: int, hash_fn):
    """One bucket read + slab compare over flat int32 lanes.

    Returns (ec, aux, found, full) as in ``seekmer_tpu.ops.probe``: one
    3-state max over the row gives the matched slot's ecaux (>= 0), -1 when
    the bucket has an empty slot, -2 when it is full.
    """
    G = bucket
    hb = hash_fn(hi, lo) & (slots // bucket - 1)
    rows = table[hb]
    hi_slab = rows[:, :G]
    match = (hi_slab == hi[:, None]) & (rows[:, G:2 * G] == lo[:, None])
    occupied = torch.where(hi_slab == EMPTY, MISS, -2).to(torch.int32)
    m = torch.where(match, rows[:, 2 * G:3 * G], occupied).amax(dim=1)
    found = m >= 0
    ec = torch.where(found, m >> AUX_BITS, MISS)
    aux = torch.where(found, m & AUX_MASK, 0)
    return ec, aux, found, m == -2


def _lookup_flat(hi, lo, valid, table, main_slots: int, stash,
                 stash_slots: int, bucket: int):
    ec, aux, found, full = _bucket_lookup(hi, lo, table, main_slots, bucket,
                                          hash_kmer)
    hit = valid & found
    ec = torch.where(hit, ec, MISS)
    aux = torch.where(hit, aux, 0)
    need = valid & ~found & full
    if bool(need.any()):
        ec2, aux2, found2, _ = _bucket_lookup(hi, lo, stash, stash_slots,
                                              bucket, hash_kmer_stash)
        write = need & found2
        ec = torch.where(write, ec2, ec)
        aux = torch.where(write, aux2, aux)
    return ec, aux


def lookup_ecs_aux(hi, lo, valid, table, main_slots: int, stash,
                   stash_slots: int, bucket: int):
    """(hi, lo) lanes of any shape -> (ec, aux) int32 (ec = MISS for absent
    or invalid lanes, aux = the matched slot's EC run length, else 0)."""
    shape = hi.shape
    hi_f, lo_f, v_f = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    parts = [
        _lookup_flat(hi_f[s:s + _PLAIN_CHUNK], lo_f[s:s + _PLAIN_CHUNK],
                     v_f[s:s + _PLAIN_CHUNK], table, main_slots, stash,
                     stash_slots, bucket)
        for s in range(0, hi_f.shape[0], _PLAIN_CHUNK)
    ]
    if not parts:
        empty = torch.empty(shape, dtype=torch.int32, device=hi.device)
        return empty, empty.clone()
    ec = torch.cat([p[0] for p in parts]).to(torch.int32)
    aux = torch.cat([p[1] for p in parts]).to(torch.int32)
    return ec.reshape(shape), aux.reshape(shape)


def lookup_ecs(hi, lo, valid, table, main_slots: int, stash,
               stash_slots: int, bucket: int):
    """k-mer (hi, lo) lanes -> EC ids (MISS for absent or invalid)."""
    return lookup_ecs_aux(hi, lo, valid, table, main_slots, stash,
                          stash_slots, bucket)[0]
