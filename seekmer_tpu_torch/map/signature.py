"""Per-read EC signatures and the signature count table, plain PyTorch.

Counterpart of ``seekmer_tpu/map/signature.py``; the table keeps its field
names, shapes and dtypes, so a JAX table carries over as numpy arrays
(:func:`sig_table_from_numpy`). Reads are reduced to the sorted distinct EC
ids of their k-mer hits (the signature), single-EC signatures count into an
exact per-EC vector, and the rest count into an open-addressing table keyed
by a 64-bit fingerprint of the row, in KB-slot buckets.

The functions here are the plain versions: they run on CPU tensors in the
mapper and on either device when the kernels of ``ops/sig_cuda.py`` and
``ops/accumulate_cuda.py`` are held against them. Unlike JAX they update
the table's tensors in place; each still returns the table.

The plain claim reads the key table as int64 (a view of the same
``int32[..., KB, 2]`` storage), so a claim writes the fingerprint as one
element: a duplicate-index write then has one whole winner and cannot
leave a key assembled from two lanes' halves.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..ops.hash import (
    sig_fingerprint_init,
    sig_fingerprint_step,
    sig_slot_hash,
    to_i32,
)
from ..utils.metrics import Metrics

SIG_PAD = 0x7FFFFFFF  # sorts after every real EC id (int32 max)
KB = 8  # slots per key bucket


class SigTable(NamedTuple):
    """Signature -> count table; each array has a trailing dump row."""

    key: torch.Tensor  # int32[S/KB + 1, KB, 2] fingerprints; (0, 0) = empty
    count: torch.Tensor  # int32[S+1]
    sig: torch.Tensor  # int32[S+1, C] claimed signature rows
    overflow: torch.Tensor  # int32[] reads lost to probe overflow
    collisions: torch.Tensor  # int32[] reads merged by a fingerprint collision
    ec_count: torch.Tensor  # int32[E+1] direct single-EC counts; (1,) = off
    complex: torch.Tensor  # int32[] reads past the class cap, where counted


def make_sig_table(bits: int, max_ecs: int, num_ecs: int = 0,
                   device="cuda") -> SigTable:
    """``num_ecs`` > 0 enables the direct per-EC count vector. The table
    lives on ``device``: the card unless the caller names the CPU."""
    if not 3 <= bits <= 30:
        raise ValueError("sig_table_bits must be in [3, 30]")
    S = 1 << bits

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return SigTable(
        key=zeros(S // KB + 1, KB, 2),
        count=zeros(S + 1),
        sig=torch.full((S + 1, max_ecs), SIG_PAD, dtype=torch.int32,
                       device=device),
        overflow=zeros(),
        collisions=zeros(),
        ec_count=zeros(num_ecs + 1 if num_ecs > 0 else 1),
        complex=zeros(),
    )


def sig_table_from_numpy(fields: Mapping[str, np.ndarray],
                         device) -> SigTable:
    """A table from numpy arrays by field name, e.g. a JAX ``SigTable``'s
    fields, carried onto ``device``; ``complex``, which the JAX table
    lacks, is zeros of ``overflow``'s shape where absent."""
    fields = {"complex": np.zeros_like(fields["overflow"]), **fields}
    return SigTable(**{
        f: torch.from_numpy(np.array(fields[f], dtype=np.int32)).to(device)
        for f in SigTable._fields})


def read_signatures(ecs: torch.Tensor, valid: torch.Tensor, max_ecs: int,
                    segments: int = 1, n_complex: torch.Tensor | None = None):
    """Per-read sorted distinct EC ids, capped.

    ecs int32[B, P] (-1 = miss), valid bool[B, P]. Returns (sig int32[B, C]
    padded with SIG_PAD, mapped bool[B]); mapped is False for zero hits or
    more than C distinct ids ("complex"). ``n_complex``, an int32 scalar
    tensor, gains the number of complex reads when given.

    ``segments`` > 1 splits each row into that many equal segments (fusion
    mode's mates: 2) and returns their signatures side by side, sig
    int32[B, segments x C], with mapped the AND of the segments', as the
    JAX package's fusion branch does with one call a mate
    (``seekmer_tpu/map/driver.py:301-306``); a read is complex when one of
    its segments is.
    """
    B, W = ecs.shape
    if W % segments:
        raise ValueError(f"window axis {W} is not {segments} equal "
                         "segments")
    P = W // segments
    sig, n_distinct = _signatures(ecs.reshape(B * segments, P),
                                  valid.reshape(B * segments, P), max_ecs)
    n_distinct = n_distinct.reshape(B, segments)
    mapped = ((n_distinct > 0) & (n_distinct <= max_ecs)).all(dim=1)
    if n_complex is not None:
        n_complex.add_((n_distinct > max_ecs).any(dim=1).sum().to(
            n_complex.dtype))
    return sig.reshape(B, segments * max_ecs), mapped


def _signatures(ecs: torch.Tensor, valid: torch.Tensor, max_ecs: int):
    """(sig int32[B, C], the distinct ids of each row int64[B])."""
    x = torch.where(valid & (ecs >= 0), ecs, SIG_PAD).to(torch.int32)
    s = torch.sort(x, dim=1).values
    prev = torch.cat([torch.full_like(s[:, :1], -1), s[:, :-1]], dim=1)
    is_new = (s != prev) & (s != SIG_PAD)
    n_distinct = is_new.sum(dim=1)
    distinct = torch.where(is_new, s, SIG_PAD)
    sig = torch.sort(distinct, dim=1).values[:, :max_ecs]
    if sig.shape[1] < max_ecs:  # fewer windows than C
        sig = torch.nn.functional.pad(sig, (0, max_ecs - sig.shape[1]),
                                      value=SIG_PAD)
    return sig.contiguous(), n_distinct


def fingerprint(sig: torch.Tensor):
    """64-bit fingerprint of each row as (fp1, fp2) int32[B]; the all-zero
    pair is remapped to (1, 0) so (0, 0) can mean an empty slot."""
    i1, i2 = sig_fingerprint_init()
    B = sig.shape[0]
    h1 = torch.full((B,), i1, dtype=torch.int64, device=sig.device)
    h2 = torch.full((B,), i2, dtype=torch.int64, device=sig.device)
    for c in range(sig.shape[1]):
        h1, h2 = sig_fingerprint_step(h1, h2, sig[:, c])
    fp1, fp2 = to_i32(h1), to_i32(h2)
    fp1 = torch.where((fp1 == 0) & (fp2 == 0), 1, fp1).to(torch.int32)
    return fp1, fp2


def _weights(mapped, weights):
    w = (torch.ones_like(mapped, dtype=torch.int32) if weights is None
         else weights.to(torch.int32))
    return torch.where(mapped, w, 0)


def claim_slots(table: SigTable, sig: torch.Tensor, w: torch.Tensor,
                sig_probe: int = 32):
    """The claim rounds of :func:`accumulate`, as
    ``seekmer_tpu.map.signature.accumulate`` runs them: each lane of weight
    > 0 looks at its cursor bucket, matches its fingerprint or claims the
    first empty slot (the re-read tells who took it), and moves to the next
    bucket only when the bucket is full; at most ``sig_probe`` rounds.
    Writes the keys only. Lanes of one fingerprint that take one slot in
    the same round share it: the first of them is its winner, the others
    match its key, as a CAS decides on the card.

    Returns (slot int64[B], -1 where unresolved; won bool[B], the one lane
    a claimed slot's row comes from; left bool[B], lanes that ran out of
    rounds).
    """
    B = sig.shape[0]
    NBK = table.key.shape[0] - 1
    fp1, fp2 = fingerprint(sig)
    home = sig_slot_hash(fp1, fp2) & (NBK - 1)
    keyrow = torch.stack([fp1, fp2], dim=1).contiguous().view(torch.int64)[:, 0]
    key64 = table.key.view(torch.int64)[..., 0]  # (NBK + 1, KB), shared storage

    active = w > 0
    cursor = home
    slot = torch.full((B,), -1, dtype=torch.int64, device=sig.device)
    won = torch.zeros_like(active)
    r = 0
    while r < sig_probe and bool(active.any()):
        rows = key64[cursor]
        match = rows == keyrow[:, None]
        is_empty = rows == 0
        matched = active & match.any(dim=1)
        slot_in = match.to(torch.int32).argmax(dim=1)
        has_empty = is_empty.any(dim=1)
        first_empty = is_empty.to(torch.int32).argmax(dim=1)
        try_claim = active & ~matched & has_empty
        took = torch.zeros_like(try_claim)
        if bool(try_claim.any()):
            c = try_claim.nonzero()[:, 0]
            key64[cursor[c], first_empty[c]] = keyrow[c]
            took = try_claim & (key64[cursor, first_empty] == keyrow)
            t = took.nonzero()[:, 0]
            s, order = torch.sort(cursor[t] * KB + first_empty[t], stable=True)
            first = torch.ones_like(s, dtype=torch.bool)
            first[1:] = s[1:] != s[:-1]
            won[t[order[first]]] = True
        resolved = matched | took
        slot = torch.where(
            resolved, cursor * KB + torch.where(matched, slot_in, first_empty),
            slot)
        advance = active & ~resolved & ~has_empty
        cursor = torch.where(advance, (cursor + 1) & (NBK - 1), cursor)
        active &= ~resolved
        r += 1
    return slot, won, active


def accumulate(table: SigTable, sig: torch.Tensor, mapped: torch.Tensor,
               weights: torch.Tensor | None = None, sig_probe: int = 32,
               audit: bool = True) -> SigTable:
    """Fold one batch into the fingerprint table: :func:`claim_slots`, then
    every resolved lane's weight into ``count``, each winner's row into its
    slot, and the weight of lanes out of rounds into ``overflow``.
    ``audit`` compares the rows of the lanes that matched an existing key
    with their slot's stored row and counts mismatches into
    ``collisions``. A winner's slot holds its own row, so this counts what
    the JAX package's audit of every resolved lane counts.
    """
    w = _weights(mapped, weights)
    slot, won, left = claim_slots(table, sig, w, sig_probe)
    resolved = slot >= 0
    table.count.index_add_(0, slot[resolved], w[resolved])
    table.sig[slot[won]] = sig[won]
    table.overflow.add_(w[left].sum().to(torch.int32))
    if audit:
        m = resolved & ~won
        mismatch = (table.sig[slot[m]] != sig[m]).any(dim=1)
        table.collisions.add_(w[m][mismatch].sum().to(torch.int32))
    return table


def accumulate_direct(table: SigTable, sig: torch.Tensor,
                      mapped: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      sig_probe: int = 32, audit: bool = True) -> SigTable:
    """Single-EC rows count into the exact per-EC vector; only multi-EC
    rows fold through the fingerprint table."""
    B, C = sig.shape
    E1 = table.ec_count.shape[0]
    w = _weights(mapped, weights)
    single = (w > 0) & (sig[:, 0] != SIG_PAD)
    if C > 1:
        single &= sig[:, 1] == SIG_PAD
    tgt = sig[single, 0].to(torch.int64)
    keep = (tgt >= 0) & (tgt < E1 - 1)  # the last slot is the dump
    table.ec_count.index_add_(0, tgt[keep], w[single][keep])
    return accumulate(table, sig, mapped & ~single,
                      weights=torch.where(single, 0, w),
                      sig_probe=sig_probe, audit=audit)


def fold_batch(table: SigTable, sig: torch.Tensor, mapped: torch.Tensor,
               weights: torch.Tensor | None = None, sig_probe: int = 32,
               audit: bool = True) -> SigTable:
    """accumulate_direct when the table carries a per-EC vector, else the
    plain fingerprint accumulate."""
    fold = accumulate_direct if table.ec_count.shape[0] > 1 else accumulate
    return fold(table, sig, mapped, weights=weights, sig_probe=sig_probe,
                audit=audit)


def direct_rows(ec_count: np.ndarray, C: int):
    """Nonzero per-EC direct counts -> ([e, PAD...] rows, counts); the dump
    (last) slot is excluded."""
    ec = np.asarray(ec_count)
    nz = np.flatnonzero(ec[:-1] > 0)
    rows = np.full((nz.size, C), SIG_PAD, np.int32)
    if nz.size:
        rows[:, 0] = nz.astype(np.int32)
    return rows, ec[nz].astype(np.int64)


def table_to_host(table: SigTable, metrics: Metrics | None = None):
    """Occupied rows to the host: (sigs int32[U, C], counts int64[U]),
    including the direct per-EC counts as single-EC rows. Only occupied
    rows cross to the host; their bytes, and the per-EC vector's, are
    counted as ``readback_bytes`` of ``metrics`` when given."""
    occ = table.count > 0
    sigs, counts, ec = (t.cpu().numpy() for t in (
        table.sig[occ], table.count[occ], table.ec_count))
    if metrics is not None:
        metrics.count("readback_bytes",
                      sigs.nbytes + counts.nbytes + ec.nbytes)
    counts = counts.astype(np.int64)
    if ec.shape[0] > 1:
        drows, dcounts = direct_rows(ec, sigs.shape[1])
        if drows.shape[0]:
            sigs = np.concatenate([sigs, drows])
            counts = np.concatenate([counts, dcounts])
    return sigs, counts
