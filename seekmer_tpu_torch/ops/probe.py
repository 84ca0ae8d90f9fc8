"""Bucketized k-mer lookup, fast mode's two-phase probe and strided mode's
lookup, plain PyTorch.

Counterpart of ``seekmer_tpu/ops/probe.py`` ``_bucket_lookup``,
``lookup_ecs_aux``, ``lookup_ecs``, ``two_phase_signatures`` and
``lookup_ecs_strided``. These run on CPU tensors and are what the lookup
kernel (``ops/probe_cuda.py``), fast mode's kernels (``ops/fast_cuda.py``)
and strided mode's (``ops/strided_cuda.py``) are held against.

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

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..map.signature import SIG_PAD, read_signatures
from .hash import hash_kmer, hash_kmer_stash
from .kmer_pack import pack_canonical, unpack_codes_2bit

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


# ---- fast mode: two-phase sampled probing ----------------------------------
#
# What ``seekmer_tpu/ops/probe.py`` ``two_phase_signatures`` computes, split
# into its three steps so each kernel has a plain version of exactly its
# own function: ``sample_classify`` (phase 1 and the choice of the units to
# re-probe; K5), the dense re-probe of those units (K1, K2, K3), and
# ``merge_staging`` (K6). Dropped, since they only schedule work under
# XLA's static shapes: the ``fallback_frac`` cap, its compacted rounds and
# the residual ``while_loop`` (coverage is exact whatever the cap; here
# every unit goes in one pass), and the ``_stage`` bisect hooks.


def sample_columns(P: int, stride: int) -> list:
    """Fast mode's sampled window columns of a segment of P windows: 0, s,
    2s, ... below P, then P - 1 if it is not one of them, s = max(stride,
    2). They are static over the padded width, as the JAX package samples
    them: at 100 bp in the 128 length bucket P - 1 = 103 is an invalid
    window, and the read's last real window is not sampled."""
    cols = list(range(0, P, max(stride, 2)))
    if cols[-1] != P - 1:
        cols.append(P - 1)
    return cols


def _pack(packed, bad, lengths, L: int, k: int):
    return pack_canonical(unpack_codes_2bit(packed, bad, L), lengths, k)


def sample_classify(mates, L: int, k: int, stride: int, table,
                    main_slots: int, stash, stash_slots: int, bucket: int):
    """Phase 1: look up the sampled windows of each segment and decide
    which segments phase 2 re-probes densely.

    ``mates`` holds one (packed uint8[B, (L+3)//4], bad uint8[B, (L+7)//8],
    lengths int32[B]) per segment: a single-end read has one, a pair two.
    A segment's sampled hits name at most one EC when ok; a read resolves
    when every segment is ok and one had a hit. A unit (read, segment) is
    re-probed when its read did not resolve, the segment is ambiguous or
    had no sampled hit, and it has a valid window at all (judged on every
    window, not the sampled ones).

    Returns (single int32[B, n_seg]: the segment's one sampled EC when it
    is ok and hit, else SIG_PAD; slot int32[B, n_seg]: the unit's row in
    ``units``, -1 when it is not re-probed; units: (packed, bad, lengths)
    of the Nu re-probed units, in (read, segment) order here).
    """
    n_seg = len(mates)
    cols = torch.tensor(sample_columns(L - k + 1, stride),
                        device=mates[0][0].device)
    oks, mxs, has_valid = [], [], []
    for packed, bad, lengths in mates:
        hi, lo, valid = _pack(packed, bad, lengths, L, k)
        ec = lookup_ecs(hi[:, cols], lo[:, cols], valid[:, cols], table,
                        main_slots, stash, stash_slots, bucket)
        hit = ec >= 0
        mx = torch.where(hit, ec, -1).amax(dim=1)
        oks.append((mx < 0) | (~hit | (ec == mx[:, None])).all(dim=1))
        mxs.append(mx)
        has_valid.append(valid.any(dim=1))
    ok, mx = torch.stack(oks, dim=1), torch.stack(mxs, dim=1)
    resolved = (mx >= 0).any(dim=1) & ok.all(dim=1)
    single = torch.where(ok & (mx >= 0), mx, SIG_PAD).to(torch.int32)
    need = (~resolved[:, None] & (~ok | (mx < 0))
            & torch.stack(has_valid, dim=1))
    flat = need.reshape(-1)
    slot = torch.where(flat, torch.cumsum(flat, 0) - 1, -1).to(
        torch.int32).reshape(need.shape)
    units = flat.nonzero().squeeze(1)
    b, g = units // n_seg, units % n_seg
    return single, slot, tuple(torch.stack([m[i] for m in mates], dim=1)[b, g]
                               for i in range(3))


def merge_staging(single, slot, sig_d, mapped_d, max_ecs: int):
    """Merge each read's segment contributions into its signature.

    A segment contributes its unit's dense signature row ``sig_d[slot]``
    when it was re-probed, else its ``single`` EC (nothing when SIG_PAD).
    sig = the first C of the sorted distinct contributions; over = more
    than C of them; a re-probed segment with hits that is unmapped on its
    own (more than C distinct ECs) forces the read unmapped; mapped = some
    contribution & ~over & ~forced. Returns (sig int32[B, C], mapped
    bool[B]), as ``seekmer_tpu/ops/probe.py:481-490`` builds them.
    """
    B, n_seg = single.shape
    C = max_ecs
    staging = torch.full((B, n_seg, C), SIG_PAD, dtype=torch.int32,
                         device=single.device)
    staging[:, :, 0] = single
    has = slot >= 0
    rows = slot[has].long()
    staging[has] = sig_d[rows]
    forced = torch.zeros((B, n_seg), dtype=torch.bool, device=single.device)
    forced[has] = (sig_d[rows, 0] != SIG_PAD) & ~mapped_d[rows]
    flat = torch.sort(staging.reshape(B, n_seg * C), dim=1).values
    if n_seg * C > 1:
        dup = torch.cat([torch.zeros_like(flat[:, :1], dtype=torch.bool),
                         flat[:, 1:] == flat[:, :-1]], dim=1)
        flat = torch.sort(torch.where(dup, SIG_PAD, flat), dim=1).values
    over = (flat[:, C] != SIG_PAD if n_seg > 1
            else torch.zeros(B, dtype=torch.bool, device=single.device))
    mapped = (flat[:, 0] != SIG_PAD) & ~over & ~forced.any(dim=1)
    return flat[:, :C].contiguous(), mapped


class FastSteps(NamedTuple):
    """The functions fast mode's signatures are made of."""

    sample: Callable  # sample_classify
    pack: Callable  # (packed, bad, lengths, L, k) -> (hi, lo, valid)
    lookup: Callable  # lookup_ecs
    signatures: Callable  # read_signatures
    merge: Callable  # merge_staging


PLAIN = FastSteps(sample_classify, _pack, lookup_ecs, read_signatures,
                  merge_staging)


def two_phase_signatures(mates, L: int, k: int, stride: int, max_ecs: int,
                         table, main_slots: int, stash, stash_slots: int,
                         bucket: int, steps: FastSteps = PLAIN):
    """Fast mode's (sig int32[B, C], mapped bool[B]) of a batch: phase 1
    on the sampled windows, a dense re-probe of the units it picks (pack,
    lookup, signatures at width C), then the merge. ``mates`` as in
    :func:`sample_classify`; ``steps`` swaps in other implementations of
    the steps (``ops/fast_cuda.KERNELS``). With no unit to re-probe, phase
    2 runs nothing."""
    geo = (table, main_slots, stash, stash_slots, bucket)
    single, slot, (packed, bad, lengths) = steps.sample(mates, L, k, stride,
                                                        *geo)
    if packed.shape[0]:
        hi, lo, valid = steps.pack(packed, bad, lengths, L, k)
        sig_d, mapped_d = steps.signatures(steps.lookup(hi, lo, valid, *geo),
                                           valid, max_ecs)
    else:
        sig_d = torch.empty((0, max_ecs), dtype=torch.int32,
                            device=single.device)
        mapped_d = torch.empty(0, dtype=torch.bool, device=single.device)
    return steps.merge(single, slot, sig_d, mapped_d, max_ecs)


# ---- strided mode: sampled probe + run-length gap fill ---------------------


def strided_columns(P: int, stride: int) -> list:
    """Strided mode's sampled columns of a segment of P windows: 0, s, 2s,
    ... below P, then P - 1 always, even when it is already one of them
    (``seekmer_tpu/ops/probe.py:519-520`` appends it unconditionally, and
    the last gap's right sample is that extra column)."""
    return list(range(0, P, stride)) + [P - 1]


def lookup_ecs_strided(hi, lo, valid, table, main_slots: int, stash,
                       stash_slots: int, bucket: int, stride: int):
    """Strided lookup of one segment a row, (hi, lo, valid) [B, P] -> ec
    int32 [B, P], equal to ``seekmer_tpu/ops/probe.py:493-585``
    ``lookup_ecs_strided`` bit for bit.

    The sampled columns (:func:`strided_columns`) are looked up with their
    aux, the EC run length d ("d adjacent windows share this EC in every
    indexed context"). A gap window p between samples pl and pr takes the
    left sample's EC when it hit and d_l >= p - pl, else the right
    sample's when it hit and d_r >= pr - p; sampled windows keep their own
    result; valid windows covered from neither side are looked up as they
    are. Invalid windows are MISS.

    The JAX form block-compacts the uncovered windows into capped rounds
    (``block_compact``, ``max_blocks``) and drains the residue with a
    ``while_loop``: that only schedules work under XLA's static shapes.
    Here every needy window goes through :func:`lookup_ecs` in one pass.
    """
    if stride <= 1:
        return lookup_ecs(hi, lo, valid, table, main_slots, stash,
                          stash_slots, bucket)
    geo = (table, main_slots, stash, stash_slots, bucket)
    ec, need = strided_fill(hi, lo, valid, *geo, stride)
    if bool(need.any()):
        ones = torch.ones(int(need.sum()), dtype=torch.bool,
                          device=hi.device)
        ec[need] = lookup_ecs(hi[need], lo[need], ones, *geo)
    return torch.where(valid, ec, MISS).to(torch.int32)


def strided_fill(hi, lo, valid, table, main_slots: int, stash,
                 stash_slots: int, bucket: int, stride: int):
    """The sampled lookup and the fill of :func:`lookup_ecs_strided`:
    returns (ec int32 [B, P], the sampled windows' results and the filled
    ones, MISS elsewhere; need bool [B, P], the valid windows neither
    sample covers, which are looked up as they are)."""
    B, P = hi.shape
    s = stride
    if P == 0:
        return (torch.empty((B, 0), dtype=torch.int32, device=hi.device),
                torch.zeros((B, 0), dtype=torch.bool, device=hi.device))
    cols = torch.tensor(strided_columns(P, s), device=hi.device)
    ec_s, d_s = lookup_ecs_aux(hi[:, cols], lo[:, cols], valid[:, cols],
                               table, main_slots, stash, stash_slots, bucket)
    pos = torch.arange(P, device=hi.device)
    gap = pos // s  # left sample gap, right sample gap + 1
    pl = gap * s
    pr = torch.clamp(pl + s, max=P - 1)
    ec_l, d_l = ec_s[:, gap], d_s[:, gap]
    ec_r, d_r = ec_s[:, gap + 1], d_s[:, gap + 1]
    cov_l = (ec_l >= 0) & (d_l >= pos - pl)
    cov_r = (ec_r >= 0) & (d_r >= pr - pos)
    is_sample = (pos % s == 0) | (pos == P - 1)
    sampled = torch.where(pos == P - 1, ec_s[:, -1:], ec_l)
    fill = torch.where(cov_l, ec_l, torch.where(cov_r, ec_r, MISS))
    ec = torch.where(is_sample, sampled, fill).to(torch.int32)
    return ec, ~is_sample & ~cov_l & ~cov_r & valid
