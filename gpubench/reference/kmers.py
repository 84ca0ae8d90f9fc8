"""Canonical k-mers, the k-mer -> transcript-set table, and pseudoalignment
of reads against it, in plain PyTorch.

A k-mer's key is its 2k-bit big-endian code (A=0, C=1, G=2, T=3) or that
of its reverse complement, whichever is smaller; a window holding any
other base is invalid. The table is every valid window of every
transcript, sorted by key: for each distinct key its class (the set of
transcripts holding it, as an id shared by keys with equal sets) and,
where the key occurs exactly once in the whole transcriptome, that
transcript and the window's start in it.

A read's signature is the set of distinct classes of its valid windows
found in the table (both mates' windows for a pair); a read with none, or
with more than ``max_ecs`` distinct classes, is unmapped. Its equivalence
class is the intersection of its classes' transcript sets; an empty
intersection is unmapped too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


def _i64(x: int) -> int:
    x &= _MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


_M1 = _i64(0xFF51AFD7ED558CCD)
_M2 = _i64(0xC4CEB9FE1A85EC53)
_M3 = _i64(0x9E3779B97F4A7C15)
_M4 = _i64(0xD6E8FEB86659FD93)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit finalizer on int64 bit patterns (multiplication wraps)."""
    x = x ^ _srl(x, 33)
    x = x * _M1
    x = x ^ _srl(x, 33)
    x = x * _M2
    return x ^ _srl(x, 33)


def windows(codes: torch.Tensor, k: int):
    """Canonical keys and validity of every k-window of uint8 code rows
    [n, L] (or one 1-D sequence): (keys int64 [n, P], valid bool [n, P])."""
    one = codes.dim() == 1
    c = codes.reshape(1, -1) if one else codes
    n, L = c.shape
    P = L - k + 1
    dev = c.device
    if P <= 0:
        keys = torch.zeros((n, 0), dtype=torch.int64, device=dev)
        valid = torch.zeros((n, 0), dtype=torch.bool, device=dev)
    else:
        c = c.to(torch.int64)
        bad = c > 3
        c = torch.where(bad, 0, c)
        fwd = torch.zeros((n, P), dtype=torch.int64, device=dev)
        rc = torch.zeros((n, P), dtype=torch.int64, device=dev)
        for j in range(k):
            col = c[:, j:j + P]
            fwd = (fwd << 2) | col
            rc = rc | ((3 - col) << (2 * j))
        keys = torch.minimum(fwd, rc)
        nbad = torch.zeros((n, L + 1), dtype=torch.int32, device=dev)
        nbad[:, 1:] = torch.cumsum(bad.to(torch.int32), dim=1)
        valid = (nbad[:, k:] - nbad[:, :P]) == 0
    if one:
        return keys[0], valid[0]
    return keys, valid


def group_lists(gid: torch.Tensor, vals: torch.Tensor, G: int):
    """Give equal lists equal ids. ``gid`` (nondecreasing, int64 [m])
    names the list of each value in ``vals``; every list 0..G-1 is
    non-empty. Returns (ids int64 [G], offsets int64 [n + 1], values
    [offsets[-1]]): the id of each list and the CSR of each id's list.
    Lists are grouped by two 64-bit hashes of (value, place) and their
    length, and the grouping is then verified element by element, so a
    hash collision raises rather than merging two lists."""
    dev = gid.device
    m = gid.numel()
    lens = torch.bincount(gid, minlength=G)
    starts = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(lens, 0)
    pos = torch.arange(m, device=dev) - starts[:-1][gid]
    v = vals.to(torch.int64)
    h1 = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
        0, gid, mix64(v * _M3 + pos))
    h2 = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
        0, gid, mix64((v ^ _M4) + pos * _M1 + 1))
    trip = torch.stack([h1, h2, lens], dim=1)
    _, ids = torch.unique(trip, dim=0, return_inverse=True)
    n = int(ids.max()) + 1 if G else 0
    rep = torch.full((n,), G, dtype=torch.int64, device=dev).scatter_reduce_(
        0, ids, torch.arange(G, device=dev), reduce="amin")
    # verify: every list equals its id's representative, element by element
    r = rep[ids]
    if bool((lens[r] != lens).any()) or bool(
            (v != v[starts[:-1][r][gid] + pos]).any()):
        raise RuntimeError("list grouping hit a hash collision")
    rl = lens[rep]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(rl, 0)
    within = (torch.arange(int(offsets[-1]), device=dev)
              - torch.repeat_interleave(offsets[:-1], rl))
    out = v[torch.repeat_interleave(starts[:-1][rep], rl) + within]
    return ids, offsets, out


def build_table(concat: torch.Tensor, lens: torch.Tensor, k: int,
                chunk: int = 1 << 24) -> Dict[str, torch.Tensor]:
    """The k-mer table of transcripts whose codes are ``concat`` (uint8,
    transcripts back to back, ``lens`` int64 [T]), on ``concat``'s device.
    Returns keys (sorted, distinct), cls (class of each key), cls_off and
    cls_tids (each class's sorted transcripts), uniq_tid (the transcript of
    a key that occurs once in the transcriptome, else -1) and uniq_pos
    (its window start there)."""
    dev = concat.device
    T = lens.numel()
    starts = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(lens, 0)
    total = int(starts[-1])
    ks, ts, ps = [], [], []
    for s in range(0, total, chunk):
        e = min(total, s + chunk + k - 1)
        key, valid = windows(concat[s:e], k)
        g = torch.arange(s, s + key.numel(), device=dev)
        tid = torch.searchsorted(starts, g, right=True) - 1
        pos = g - starts[tid]
        # a window must lie inside one transcript
        valid &= pos + k <= lens[tid]
        ks.append(key[valid])
        ts.append(tid[valid])
        ps.append(pos[valid])
    keys, tids, pos = torch.cat(ks), torch.cat(ts), torch.cat(ps)
    del ks, ts, ps
    keys, order = torch.sort(keys, stable=True)  # tids stay in order
    tids, pos = tids[order], pos[order]
    del order
    m = keys.numel()
    new_key = torch.ones(m, dtype=torch.bool, device=dev)
    new_key[1:] = keys[1:] != keys[:-1]
    key_id = torch.cumsum(new_key.to(torch.int64), 0) - 1
    K = int(key_id[-1]) + 1 if m else 0
    occ = torch.bincount(key_id, minlength=K)
    first = torch.nonzero(new_key).flatten()
    uniq = occ == 1
    uniq_tid = torch.where(uniq, tids[first], -1).to(torch.int32)
    uniq_pos = torch.where(uniq, pos[first], 0).to(torch.int32)
    keep = new_key.clone()
    keep[1:] |= tids[1:] != tids[:-1]
    cls, cls_off, cls_tids = group_lists(key_id[keep], tids[keep], K)
    return {"keys": keys[first].contiguous(), "cls": cls.to(torch.int32),
            "cls_off": cls_off, "cls_tids": cls_tids.to(torch.int32),
            "uniq_tid": uniq_tid, "uniq_pos": uniq_pos}


def lookup(tab: Dict[str, torch.Tensor], keys: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Row of each valid key in the table, -1 where absent or invalid."""
    tk = tab["keys"]
    if tk.numel() == 0:
        return torch.full_like(keys, -1)
    i = torch.searchsorted(tk, keys).clamp_(max=tk.numel() - 1)
    return torch.where(valid & (tk[i] == keys), i, -1)


BIG = (1 << 62)


def signatures(cls_rows: torch.Tensor, max_ecs: int):
    """Per row (class ids, -1 = none): (sorted distinct classes padded with
    BIG, int64 [n, max_ecs]; mapped bool [n])."""
    x = torch.where(cls_rows >= 0, cls_rows.to(torch.int64), BIG)
    s = torch.sort(x, dim=1).values
    prev = torch.cat([torch.full_like(s[:, :1], -1), s[:, :-1]], dim=1)
    new = (s != prev) & (s != BIG)
    nd = new.sum(dim=1)
    sig = torch.sort(torch.where(new, s, BIG), dim=1).values[:, :max_ecs]
    if sig.shape[1] < max_ecs:
        sig = torch.nn.functional.pad(sig, (0, max_ecs - sig.shape[1]),
                                      value=BIG)
    return sig, (nd > 0) & (nd <= max_ecs)


FLD_OFFSETS = (0, 7, 15, 23)
FLD_MAX = 1024


def _fld_pin(tab, keys, valid, rows):
    """Per read, the first of FLD_OFFSETS whose k-mer occurs once in the
    transcriptome: (transcript or -1, its position, the offset)."""
    P = keys.shape[1]
    offs = [o for o in FLD_OFFSETS if o < P] or [0]
    if P == 0:
        z = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
        return z - 1, z, z
    tid = torch.full((keys.shape[0],), -1, dtype=torch.int64,
                     device=keys.device)
    q = torch.zeros_like(tid)
    off = torch.zeros_like(tid)
    for o in reversed(offs):  # the first offset that pins wins
        r = rows[:, o]
        ok = r >= 0
        t = torch.where(ok, tab["uniq_tid"][r.clamp(min=0)].to(torch.int64),
                        -1)
        hit = t >= 0
        tid = torch.where(hit, t, tid)
        q = torch.where(hit, tab["uniq_pos"][r.clamp(min=0)].to(torch.int64),
                        q)
        off = torch.where(hit, torch.full_like(off, o), off)
    return tid, q, off


def map_reads(tab: Dict[str, torch.Tensor], codes1: Sequence[torch.Tensor],
              codes2: Optional[Sequence[torch.Tensor]], k: int, max_ecs: int,
              block: int = 1 << 16) -> Dict[str, torch.Tensor]:
    """Pseudoalign every fragment of the lanes ``codes1`` (and mates
    ``codes2``; uint8 [n, L] tensors on the table's device). Returns the
    fragment count, the distinct signatures of mapped fragments with their
    counts, and for pairs the fragment-length histogram (index 0 unused)
    of the pairs whose mates both pin to one transcript at a unique k-mer:
    f = |q1 - q2| + k + o1 + o2, kept when max(L1, L2) <= f <= FLD_MAX."""
    dev = tab["keys"].device
    sigs, total = [], 0
    hist = torch.zeros(FLD_MAX + 1, dtype=torch.int64, device=dev)
    for li, lane in enumerate(codes1):
        for s in range(0, lane.shape[0], block):
            c1 = lane[s:s + block].to(dev)
            total += c1.shape[0]
            k1, v1 = windows(c1, k)
            r1 = lookup(tab, k1, v1)
            rows = [torch.where(r1 >= 0, tab["cls"][r1.clamp(min=0)], -1)]
            if codes2 is not None:
                c2 = codes2[li][s:s + block].to(dev)
                k2, v2 = windows(c2, k)
                r2 = lookup(tab, k2, v2)
                rows.append(torch.where(r2 >= 0,
                                        tab["cls"][r2.clamp(min=0)], -1))
                t1, q1, o1 = _fld_pin(tab, k1, v1, r1)
                t2, q2, o2 = _fld_pin(tab, k2, v2, r2)
                f = (q1 - q2).abs() + k + o1 + o2
                minf = max(c1.shape[1], c2.shape[1])
                ok = (t1 >= 0) & (t1 == t2) & (f >= minf) & (f <= FLD_MAX)
                hist.index_add_(0, f[ok], torch.ones_like(f[ok]))
            sig, mapped = signatures(torch.cat(rows, dim=1), max_ecs)
            sigs.append(sig[mapped])
    allsig = torch.cat(sigs) if sigs else torch.zeros(
        (0, max_ecs), dtype=torch.int64, device=dev)
    usig, counts = torch.unique(allsig, dim=0, return_counts=True)
    return {"total": total, "sigs": usig, "sig_counts": counts,
            "fld_hist": hist}


def resolve(tab: Dict[str, torch.Tensor], sigs: torch.Tensor,
            sig_counts: torch.Tensor, T: int):
    """Intersect each signature's transcript sets and merge signatures
    with equal intersections: (ec_off, ec_tids, ec_counts, dropped), the
    equivalence classes as a CSR with their fragment counts, and the
    fragments whose intersection is empty."""
    dev = sigs.device
    U = sigs.shape[0]
    present = sigs != BIG
    n_cls = present.sum(dim=1)
    u = torch.arange(U, device=dev)[:, None].expand_as(sigs)[present]
    c = sigs[present]
    off = tab["cls_off"]
    ln = off[c + 1] - off[c]
    uu = torch.repeat_interleave(u, ln)
    o = torch.zeros(ln.numel() + 1, dtype=torch.int64, device=dev)
    o[1:] = torch.cumsum(ln, 0)
    within = torch.arange(int(o[-1]), device=dev) - torch.repeat_interleave(
        o[:-1], ln)
    t = tab["cls_tids"][torch.repeat_interleave(off[c], ln) + within].to(
        torch.int64)
    pair, times = torch.unique(uu * T + t, return_counts=True)
    pu, pt = pair // T, pair % T
    inter = times == n_cls[pu]
    pu, pt = pu[inter], pt[inter]
    kept = torch.zeros(U, dtype=torch.bool, device=dev)
    kept[pu] = True
    dropped = int(sig_counts[~kept].sum())
    # renumber kept signatures 0..; pu is sorted, so each list is sorted
    ren = torch.cumsum(kept.to(torch.int64), 0) - 1
    ids, ec_off, ec_tids = group_lists(ren[pu], pt, int(kept.sum()))
    ec_counts = torch.zeros(ec_off.numel() - 1, dtype=torch.int64,
                            device=dev).index_add_(0, ids, sig_counts[kept])
    return ec_off, ec_tids, ec_counts, dropped


def components(ec_off: torch.Tensor, ec_tids: torch.Tensor, T: int):
    """Connected components of transcripts joined by equivalence classes:
    the smallest transcript id of each transcript's component (a
    transcript in no class is its own)."""
    dev = ec_tids.device
    E = ec_off.numel() - 1
    ec_of = torch.repeat_interleave(torch.arange(E, device=dev),
                                    ec_off[1:] - ec_off[:-1])
    lab = torch.arange(T, device=dev)
    while True:
        m = torch.full((E,), T, dtype=torch.int64, device=dev).scatter_reduce_(
            0, ec_of, lab[ec_tids], reduce="amin")
        new = lab.scatter_reduce(0, ec_tids, m[ec_of], reduce="amin")
        new = new[new]  # jump to the label's own label
        if torch.equal(new, lab):
            return lab
        lab = new
