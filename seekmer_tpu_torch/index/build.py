"""Host-side k-mer index builder, transcriptome FASTA (+ optional GTF) ->
flat-array index: the port's copy of ``seekmer_tpu/index/build.py``, with
the path the port's ``index`` command runs. Both packages build equal
arrays from the same transcripts (``tests/test_torch_self_contained.py``).

Everything is vectorized numpy; no Python loop touches individual k-mers:

  1. one canonical-k-mer pass over the separator-joined transcriptome;
  2. a global sort of (key, transcript) pairs (the C radix sort of
     ``native/packer.c`` from ``_NATIVE_SORT_MIN`` pairs up), dedupe,
     group by key;
  3. equivalence classes = groups of keys with identical transcript sets,
     found by 128-bit order-sensitive fingerprints over the sorted sets;
  4. bucketized placement: sort keys by home bucket, rank within the
     bucket, keep rank < bucket_size; keys whose home bucket is full go to
     a low-load stash table, so one bucket probe finds any key.

Left out of the copy: ``collect_kmer_pairs`` and the branches of
``group_equivalence_classes`` and ``compute_run_lengths`` for pair streams
out of transcript order or without precomputed ranks, which
``build_index_from_seqs`` never takes.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from ..config import IndexConfig
from ..encoding import canonical_kmers, seq_to_codes, split_key
from ..ops.hash import hash_kmer_np, hash_kmer_stash_np
from .store import EMPTY, KMerIndex

log = logging.getLogger(__name__)

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_M3 = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(33))
    x = x * _M1
    x = x ^ (x >> np.uint64(33))
    x = x * _M2
    x = x ^ (x >> np.uint64(33))
    return x


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _concat_codes(seqs: list[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate transcript codes with INVALID separators, so windows
    spanning transcript boundaries are invalid and ONE vectorized k-mer
    pass covers the whole transcriptome. Returns (codes uint8, starts
    int64[T]): transcript t occupies codes[starts[t] : starts[t] + len_t].
    """
    lengths = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    total = int(lengths.sum()) + len(seqs)
    codes = np.full(total, 4, np.uint8)
    starts = np.zeros(len(seqs), np.int64)
    off = 0
    for t, s in enumerate(seqs):
        starts[t] = off
        c = seq_to_codes(s)
        codes[off : off + c.size] = c
        off += c.size + 1
    return codes, starts


# Pair counts below this sort via numpy (the C radix sort's win is a
# large-scale one; tests lower it to compare the two).
_NATIVE_SORT_MIN = 1 << 20


def group_equivalence_classes(keys: np.ndarray, tids: np.ndarray):
    """Group k-mers by identical transcript set; ``tids`` arrive in
    transcript order (nondecreasing), so one stable sort by key gives
    (key, tid) order.

    Returns (unique_keys, key_ec, ec_offsets, ec_transcripts, key_rank):
    key_ec[i] is the EC id of unique_keys[i]; CSR (ec_offsets,
    ec_transcripts) holds each EC's sorted transcript ids; key_rank is each
    INPUT pair's rank into unique_keys.
    """
    n_pairs = keys.size
    if n_pairs >= _NATIVE_SORT_MIN:
        from ..native.packer import sort_pairs_native

        keys, tids, key_rank = sort_pairs_native(keys, tids)
    else:
        order = np.argsort(keys, kind="stable")
        keys, tids = keys[order], tids[order]
        new_key_all = np.ones(n_pairs, dtype=bool)
        new_key_all[1:] = keys[1:] != keys[:-1]
        krank_sorted = np.cumsum(new_key_all, dtype=np.int64) - 1
        key_rank = np.empty(n_pairs, np.int64)
        key_rank[order] = krank_sorted
    keep = np.ones(keys.size, dtype=bool)
    keep[1:] = (keys[1:] != keys[:-1]) | (tids[1:] != tids[:-1])
    keys, tids = keys[keep], tids[keep]

    # Key-group boundaries.
    new_key = np.ones(keys.size, dtype=bool)
    new_key[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(new_key)
    unique_keys = keys[starts]
    group_len = np.diff(np.append(starts, keys.size)).astype(np.int64)

    # Order-sensitive 128-bit fingerprint of each group's (sorted) tid list.
    pos = np.arange(keys.size, dtype=np.int64) - np.repeat(starts, group_len)
    t64 = tids.astype(np.uint64)
    p64 = pos.astype(np.uint64)
    c1 = _mix64(t64 * _M3 + p64)
    c2 = c1 ^ (c1 >> np.uint64(29)) ^ (t64 << np.uint64(31)) ^ _M2
    h1 = np.add.reduceat(c1, starts) if starts.size else np.empty(0, np.uint64)
    h2 = np.add.reduceat(c2, starts) if starts.size else np.empty(0, np.uint64)

    # fold the group length into the fingerprints and group by a 2-key
    # lexsort
    gl = group_len.astype(np.uint64)
    h1 = h1 ^ _mix64(gl * _M1)
    h2 = h2 + _mix64(gl ^ _M2)
    order = np.lexsort((h2, h1))
    a, b = h1[order], h2[order]
    new_ec = np.ones(a.size, dtype=bool)
    new_ec[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    ec_sorted = np.cumsum(new_ec) - 1
    key_ec = np.empty(a.size, np.int64)
    key_ec[order] = ec_sorted
    key_ec = key_ec.astype(np.int32)
    first_idx = order[np.flatnonzero(new_ec)]

    # EC member lists from each EC's first key group.
    ec_starts = starts[first_idx]
    ec_lens = group_len[first_idx]
    ec_offsets = np.zeros(first_idx.size + 1, dtype=np.int64)
    np.cumsum(ec_lens, out=ec_offsets[1:])
    gather = ec_starts.repeat(ec_lens) + (
        np.arange(int(ec_offsets[-1]), dtype=np.int64)
        - ec_offsets[:-1].repeat(ec_lens)
    )
    ec_transcripts = tids[gather].astype(np.int32)
    return (unique_keys, key_ec, ec_offsets.astype(np.int32), ec_transcripts,
            key_rank)


def build_bucket_table(
    hi: np.ndarray,
    lo: np.ndarray,
    vals: np.ndarray,
    n_buckets: int,
    bucket: int,
    hash_fn,
    aux: Optional[np.ndarray] = None,
    return_placement: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Place keys in their home bucket (hash & (n_buckets-1)); a bucket holds
    ``bucket`` slots. Keys whose home bucket is full are returned in the
    overflow mask, NOT placed: the caller routes them to the stash.

    Returns (table int32[n_buckets*bucket, 4], overflow_mask), as the JAX
    package's does; ``return_placement`` appends (slot, src): placed key
    ``src[i]`` landed in table slot ``slot[i]``, from which callers fill
    per-slot payloads (the FLD positions).
    """
    mask = np.uint32(n_buckets - 1)
    homes = (hash_fn(hi.view(np.uint32), lo.view(np.uint32)) & mask).astype(
        np.int64
    )
    order = np.argsort(homes, kind="stable")
    hs = homes[order]
    idx = np.arange(hs.size, dtype=np.int64)
    first = np.ones(hs.size, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    group_start = np.maximum.accumulate(np.where(first, idx, 0))
    rank = idx - group_start
    keep = rank < bucket

    overflow = np.zeros(hi.size, dtype=bool)
    overflow[order[~keep]] = True

    slot = hs[keep] * bucket + rank[keep]
    src = order[keep]
    table = np.full((n_buckets * bucket, 4), EMPTY, dtype=np.int32)
    table[slot, 0] = hi[src]
    table[slot, 1] = lo[src]
    table[slot, 2] = vals[src]
    table[slot, 3] = 0 if aux is None else aux[src]
    if return_placement:
        return table, overflow, slot, src
    return table, overflow


def build_tables(
    unique_keys: np.ndarray, key_ec: np.ndarray, k: int, cfg: IndexConfig,
    aux: Optional[np.ndarray] = None,
    fld: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> dict:
    """Bucketized 2-choice tables: every key lives in its main home bucket
    or, if that bucket is full, its stash home bucket. ``aux`` (per-key EC
    run lengths) is written at placement; ``fld`` = per-key (utid, upos)
    unique-occurrence payload (map/fld.py), scattered into per-slot arrays
    by the same placement."""
    hi, lo = split_key(unique_keys, k)
    n = unique_keys.size
    G = cfg.bucket_size
    n_buckets = _next_pow2(
        max(int(np.ceil(n / (cfg.load_factor * G))), 2)
    )
    table, overflow, slot, src = build_bucket_table(
        hi, lo, key_ec, n_buckets, G, hash_kmer_np, aux=aux,
        return_placement=True)
    n_over = int(overflow.sum())
    log.info(
        "main table: %d keys, %d buckets x %d (load %.2f), %d stashed (%.2g)",
        n, n_buckets, G, n / (n_buckets * G), n_over,
        n_over / max(n, 1),
    )

    s_hi, s_lo, s_val = hi[overflow], lo[overflow], key_ec[overflow]
    s_aux = None if aux is None else aux[overflow]
    stash_buckets = _next_pow2(
        max(cfg.stash_min_slots // G,
            int(np.ceil(max(n_over, 1) / (cfg.stash_load * G))), 2)
    )
    while True:
        stash, s_over, s_slot, s_src = build_bucket_table(
            s_hi, s_lo, s_val, stash_buckets, G, hash_kmer_stash_np,
            aux=s_aux, return_placement=True)
        if not s_over.any():
            break
        stash_buckets *= 2  # extremely unlikely at stash_load

    out = dict(
        table=table,
        main_slots=n_buckets * G,
        stash=stash,
        stash_slots=stash_buckets * G,
        bucket=G,
    )
    if fld is not None:
        utid, upos = fld
        S = n_buckets * G + stash_buckets * G
        fld_tid = np.full(S, -1, np.int32)
        fld_pos = np.zeros(S, np.int32)
        fld_tid[slot] = utid[src]
        fld_pos[slot] = upos[src]
        over_idx = np.flatnonzero(overflow)
        fld_tid[n_buckets * G + s_slot] = utid[over_idx[s_src]]
        fld_pos[n_buckets * G + s_slot] = upos[over_idx[s_src]]
        out["fld_tid"] = fld_tid
        out["fld_pos"] = fld_pos
    return out


def build_index(
    fasta_path: str,
    gtf_path: Optional[str] = None,
    cfg: IndexConfig = IndexConfig(),
) -> KMerIndex:
    """End-to-end index build: FASTA (+GTF) -> KMerIndex."""
    from ..io.fasta import read_fasta

    names, seqs = [], []
    for name, seq in read_fasta(fasta_path):
        names.append(name)
        seqs.append(seq)
    return build_index_from_seqs(names, seqs, gtf_path=gtf_path, cfg=cfg)


def compute_run_lengths(key_ec: np.ndarray, n_unique: int, P: int,
                        pos: np.ndarray, krank: np.ndarray,
                        cap: int = 127) -> np.ndarray:
    """Per-k-mer EC-run guarantee ``d``: for every occurrence of the k-mer,
    in every transcript and either direction, the ``d`` adjacent windows
    have the SAME EC (the aux column; the strided probe mode reads it).
    ``P`` is the window count of the separator-joined transcriptome,
    ``pos`` the valid window positions and ``krank`` their ranks into the
    unique keys; separator windows are invalid (ec = -1) and break runs at
    transcript borders.
    """
    d_min = np.full(n_unique, cap, dtype=np.int32)
    ec = np.full(P, -1, dtype=np.int64)
    ec[pos] = key_ec[krank]
    change = np.ones(P, dtype=bool)
    change[1:] = ec[1:] != ec[:-1]
    starts = np.flatnonzero(change)
    run_len = np.diff(np.append(starts, P))
    pos_in_run = np.arange(P, dtype=np.int64) - np.repeat(starts, run_len)
    d_fwd = np.repeat(run_len, run_len) - 1 - pos_in_run
    d_bwd = pos_in_run
    d = np.minimum(np.minimum(d_fwd, d_bwd), cap).astype(np.int32)
    # per-key min via ONE value sort of (key_index << 7 | d): the first
    # entry of each key group carries its minimum d (d <= cap < 128)
    m = (krank.astype(np.int64) << 7) | d[pos]
    m.sort()
    kk = m >> 7
    first = np.ones(kk.size, dtype=bool)
    first[1:] = kk[1:] != kk[:-1]
    fi = np.flatnonzero(first)
    if fi.size:
        kf = kk[fi]
        d_min[kf] = np.minimum(d_min[kf], (m[fi] & 127).astype(np.int32))
    return d_min


def build_index_from_seqs(
    names: list[str],
    seqs: list[str],
    gtf_path: Optional[str] = None,
    cfg: IndexConfig = IndexConfig(),
    genes: Optional[list[str]] = None,
) -> KMerIndex:
    # one canonical-k-mer pass over the separator-joined transcriptome,
    # shared by pair collection and the run-length pass
    seqs = list(seqs)
    lengths = np.fromiter((len(s_) for s_ in seqs), np.int32,
                          len(seqs)) if seqs else np.empty(0, np.int32)
    P = 0
    if seqs:
        codes, starts = _concat_codes(seqs)
        all_keys, all_valid = canonical_kmers(codes, cfg.k)
        P = all_valid.size
        pos = np.flatnonzero(all_valid)
        keys = all_keys[pos]
        tids = (np.searchsorted(starts, pos, side="right") - 1).astype(
            np.int32)
    else:
        keys = np.empty(0, np.uint64)
        tids = np.empty(0, np.int32)
        pos = np.empty(0, np.int64)
    log.info("collected %d k-mer pairs from %d transcripts", keys.size,
             len(names))
    unique_keys, key_ec, ec_offsets, ec_transcripts, krank = (
        group_equivalence_classes(keys, tids))
    log.info("%d distinct %d-mers in %d equivalence classes",
             unique_keys.size, cfg.k, ec_offsets.size - 1)
    aux = None
    if cfg.run_length_aux:
        aux = compute_run_lengths(key_ec, unique_keys.size, P, pos, krank)
    fld = None
    if cfg.fld_positions and keys.size:
        # k-mers occurring EXACTLY ONCE in the whole transcriptome pin an
        # unambiguous (transcript, position): the payload of
        # fragment-length estimation (map/fld.py)
        occ = np.bincount(krank, minlength=unique_keys.size)
        utid = np.full(unique_keys.size, -1, np.int32)
        upos = np.zeros(unique_keys.size, np.int32)
        w = np.flatnonzero(occ[krank] == 1)
        utid[krank[w]] = tids[w]
        upos[krank[w]] = (pos[w] - starts[tids[w]]).astype(np.int32)
        fld = (utid, upos)
        log.info("FLD payload: %d globally-unique k-mers (%.0f%%)",
                 int((utid >= 0).sum()),
                 100.0 * (utid >= 0).mean())
    tables = build_tables(unique_keys, key_ec, cfg.k, cfg, aux=aux, fld=fld)

    if genes is not None:
        genes = np.array(genes)
    elif gtf_path is not None:
        from ..io.gtf import transcript_gene_map

        t2g = transcript_gene_map(gtf_path)
        genes = np.array([t2g.get(n, "NA") for n in names])

    return KMerIndex(
        k=cfg.k,
        ec_offsets=ec_offsets,
        ec_transcripts=ec_transcripts,
        names=np.array(names),
        lengths=lengths,
        genes=genes,
        **tables,
    )
