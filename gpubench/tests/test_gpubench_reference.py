"""The plain reference (``gpubench/reference``) against brute force at tiny
sizes: k-mer classes and pseudoalignment against Python set intersection
(single-end and paired fragments, reads with N, reads that map nowhere,
reads over the class cap), the fragment-length histogram against a
per-pair loop, and float64 EM on a hand-made class table."""

import itertools

import numpy as np
import pytest
import torch

from gpubench import world as gpu_world
from gpubench.reference import em as ref_em
from gpubench.reference import kmers
from gpubench.tests import tiny

K = 5
COMP = str.maketrans("ACGTN", "TGCAN")


def rc(s):
    return s.translate(COMP)[::-1]


def canon(s):
    return min(s, rc(s))


def codes(s):
    return np.frombuffer(s.encode(), np.uint8).copy()


LUT = np.full(256, 4, np.uint8)
for i, b in enumerate(b"ACGT"):
    LUT[b] = i


def encode_rows(rows):
    L = max(len(r) for r in rows)
    out = np.full((len(rows), L), 4, np.uint8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = LUT[np.frombuffer(r.encode(), np.uint8)]
    return torch.from_numpy(out)


def brute_world(seqs, k):
    """(seqs, the reference's table, canonical k-mer -> set of
    transcripts, k-mer -> occurrences) by brute force."""
    lens = torch.tensor([len(s) for s in seqs])
    concat = torch.from_numpy(LUT[np.frombuffer("".join(seqs).encode(),
                                                np.uint8)])
    tab = kmers.build_table(concat, lens, k, chunk=37)
    where, occ = {}, {}
    for t, s in enumerate(seqs):
        for p in range(len(s) - k + 1):
            c = canon(s[p:p + k])
            where.setdefault(c, set()).add(t)
            occ.setdefault(c, []).append((t, p))
    return seqs, tab, where, occ


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    base = ["".join(rng.choice(list("ACGT"), size=n)) for n in (40, 30, 50)]
    seqs = [base[0] + base[1], base[0] + base[2], base[1] + base[2],
            base[2][:20] + base[0][:25], "".join(rng.choice(list("ACGT"),
                                                            size=60))]
    return brute_world(seqs, K)


FAMILIES_K = 11


@pytest.fixture(scope="module")
def families():
    """A world of gene families and pseudogenes (``worlds/
    gencode_families``), small enough for brute force, with each
    transcript's gene."""
    p = dict(tiny.FAMILIES, num_genes=10, mean_isoforms=3, mean_exons=4,
             mean_exon_len=40)
    make, _ = gpu_world.generator("gencode_families")
    _, seqs, genes = make(np.random.default_rng(2), p)
    return brute_world(seqs, FAMILIES_K) + (genes,)


def brute_ec(reads, where, max_ecs, k=K):
    """Per fragment (a tuple of mates): the intersection, or None."""
    sets = []
    for mate in reads:
        for p in range(len(mate) - k + 1):
            w = mate[p:p + k]
            if "N" in w:
                continue
            c = canon(w)
            if c in where:
                sets.append(frozenset(where[c]))
    distinct = set(sets)
    if not distinct or len(distinct) > max_ecs:
        return None
    inter = frozenset.intersection(*distinct)
    return inter or None


def test_table(world):
    seqs, tab, where, occ = world
    keys = tab["keys"].tolist()
    assert keys == sorted(keys) and len(keys) == len(where)
    # class ids equal exactly where transcript sets are equal
    to_int = {}
    for c in where:
        k, _ = kmers.windows(encode_rows([c])[0], K)
        to_int[c] = int(k[0])
    pos = {v: i for i, v in enumerate(keys)}
    for a, b in itertools.combinations(list(where)[:60], 2):
        same = where[a] == where[b]
        assert (int(tab["cls"][pos[to_int[a]]])
                == int(tab["cls"][pos[to_int[b]]])) == same
    for c, ts in where.items():
        i = pos[to_int[c]]
        cid = int(tab["cls"][i])
        got = tab["cls_tids"][tab["cls_off"][cid]:tab["cls_off"][cid + 1]]
        assert set(got.tolist()) == ts
        if len(occ[c]) == 1:
            assert (int(tab["uniq_tid"][i]), int(tab["uniq_pos"][i])) == \
                occ[c][0]
        else:
            assert int(tab["uniq_tid"][i]) == -1


def reads_for(seqs, rng, n, L, paired):
    seqs = [s for s in seqs if len(s) >= L]
    frags = []
    for _ in range(n):
        t = int(rng.integers(len(seqs)))
        s = seqs[t]
        f = int(rng.integers(L, len(s) + 1))
        st = int(rng.integers(0, len(s) - f + 1))
        m1 = s[st:st + L]
        m2 = rc(s[st + f - L:st + f])
        frags.append((m1, m2) if paired else (m1,))
    # reads with N, reads from nowhere, a mate with no hit
    junk = "".join(rng.choice(list("ACGT"), size=L))
    n_read = frags[0][0][:7] + "N" + frags[0][0][8:]
    frags.append((n_read, frags[1][-1]) if paired else (n_read,))
    frags.append((junk, junk) if paired else (junk,))
    frags.append((junk, frags[2][-1]) if paired else ("N" * L,))
    return frags


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("max_ecs", [16, 2])
@pytest.mark.parametrize("kind,k,L", [("world", K, 20),
                                      ("families", FAMILIES_K, 40)])
def test_map_and_resolve_against_sets(request, kind, k, L, paired,
                                      max_ecs):
    seqs, tab, where = request.getfixturevalue(kind)[:3]
    rng = np.random.default_rng(3 + paired)
    frags = reads_for(seqs, rng, 300, L, paired)
    want = {}
    for f in frags:
        ec = brute_ec(f, where, max_ecs, k)
        if ec is not None:
            want[ec] = want.get(ec, 0) + 1
    l1 = [encode_rows([f[0] for f in frags])]
    l2 = [encode_rows([f[1] for f in frags])] if paired else None
    m = kmers.map_reads(tab, l1, l2, k, max_ecs, block=64)
    assert m["total"] == len(frags)
    off, tids, cnt, dropped = kmers.resolve(tab, m["sigs"], m["sig_counts"],
                                            len(seqs))
    got = {frozenset(tids[off[i]:off[i + 1]].tolist()): int(cnt[i])
           for i in range(off.numel() - 1)}
    assert got == want
    assert sum(want.values()) + dropped <= len(frags)
    if kind == "families":
        # classes whose transcripts span genes; fragments over the cap of 2
        genes = request.getfixturevalue(kind)[4]
        if max_ecs > 2:
            assert any(len({genes[t] for t in e}) > 1 for e in want)
        else:
            assert sum(want.values()) < sum(
                brute_ec(f, where, 16, k) is not None for f in frags)


def test_fld_histogram_against_loop(world):
    seqs, tab, _, occ = world
    rng = np.random.default_rng(11)
    frags = reads_for(seqs, rng, 200, 30, True)
    uniq = {c: v[0] for c, v in occ.items() if len(v) == 1}

    def pin(m):
        for o in kmers.FLD_OFFSETS:
            if o + K <= len(m):
                w = m[o:o + K]
                if "N" not in w and canon(w) in uniq:
                    t, q = uniq[canon(w)]
                    return t, q, o
        return None

    want = np.zeros(kmers.FLD_MAX + 1, np.int64)
    for m1, m2 in frags:
        a, b = pin(m1), pin(m2)
        if a and b and a[0] == b[0]:
            f = abs(a[1] - b[1]) + K + a[2] + b[2]
            if max(len(m1), len(m2)) <= f <= kmers.FLD_MAX:
                want[f] += 1
    m = kmers.map_reads(tab, [encode_rows([f[0] for f in frags])],
                        [encode_rows([f[1] for f in frags])], K, 16)
    assert want.sum() > 20
    assert m["fld_hist"].tolist() == want.tolist()


def test_components():
    off = torch.tensor([0, 1, 3, 5, 6])
    tids = torch.tensor([0, 1, 4, 4, 6, 2])
    lab = kmers.components(off, tids, 7)
    assert lab.tolist() == [0, 1, 2, 3, 1, 5, 1]


EM_CFG = {"rel_tol": 1e-12, "abs_floor": 1e-300, "count_floor": 1e-8,
          "min_iters": 10, "max_iters": 200000, "check_every": 16}


def test_em_hand_made():
    # classes {0}: 10, {0,1}: 20, {1,2}: 5, {2}: 1, {3,4}: 7
    off = torch.tensor([0, 1, 3, 5, 6, 8])
    tids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 4])
    counts = torch.tensor([10, 20, 5, 1, 7])
    lens = torch.tensor([300, 500, 250, 1000, 1000])
    eff = ref_em.effective_lengths(lens, 200.0, 20.0)
    ecs = ref_em.ECs(off, tids, 5)
    theta, it, stat = ref_em.run(ecs, counts, eff, EM_CFG)
    assert it < EM_CFG["max_iters"] and stat < EM_CFG["rel_tol"]
    assert it % 16 == 0
    # a fixed point, mass kept per component, symmetric pair split evenly
    nxt = ref_em.em_step(theta, ecs, counts.double(), 1.0 / eff)
    assert torch.allclose(nxt, theta, rtol=1e-9, atol=1e-12)
    assert float(theta[:3].sum()) == pytest.approx(36.0, rel=1e-12)
    assert float(theta[3]) == pytest.approx(3.5, rel=1e-12)
    # a plain loop of the same steps gives the same iterate
    t = torch.full((5,), 43.0 / 5, dtype=torch.float64)
    ec_of = [0, 1, 1, 2, 2, 3, 4, 4]
    for _ in range(it):
        w = [float(t[x]) / float(eff[x]) for x in tids.tolist()]
        d = [0.0] * 5
        for e, v in zip(ec_of, w):
            d[e] += v
        new = [0.0] * 5
        for e, x, v in zip(ec_of, tids.tolist(), w):
            new[x] += float(counts[e]) * v / d[e]
        t = torch.tensor(new, dtype=torch.float64)
    assert torch.allclose(t, theta, rtol=1e-12)
    # exactly ``iters`` steps, and the replicate form agrees column-wise
    t5, it5, _ = ref_em.run(ecs, counts, eff, EM_CFG, iters=5)
    assert it5 == 5
    tb, _, _ = ref_em.run(ecs, torch.stack([counts, counts], 1), eff,
                          EM_CFG, iters=5)
    assert torch.allclose(tb[:, 0], t5) and torch.allclose(tb[:, 1], t5)


def test_effective_lengths():
    lens = torch.tensor([1, 150, 300, 5000])
    assert ref_em.effective_lengths(lens, 200.0, 0.0).tolist() == \
        [1.0, 1.0, 101.0, 4801.0]
    e = ref_em.effective_lengths(lens, 200.0, 20.0)
    f = np.arange(1, 301)
    p = np.exp(-0.5 * ((f - 200) / 20) ** 2)
    want = ((300 - f + 1) * p).sum() / p.sum()
    assert float(e[2]) == pytest.approx(want, rel=1e-12)
    assert float(e[3]) == pytest.approx(5000 - 200 + 1, rel=1e-6)


def test_fld_estimate():
    h = torch.zeros(11, dtype=torch.int64)
    h[0] = 99  # index 0 is never a length
    h[4], h[6] = 60, 60
    assert ref_em.fld_estimate(h, min_samples=10) == pytest.approx(
        (5.0, float(np.std([4] * 60 + [6] * 60, ddof=1)), 120))
    assert ref_em.fld_estimate(h, min_samples=1000) is None


def test_group_lists_detects_nothing_false():
    gid = torch.tensor([0, 0, 1, 1, 2, 3, 3])
    vals = torch.tensor([1, 2, 1, 2, 1, 2, 1])
    ids, off, out = kmers.group_lists(gid, vals, 4)
    assert ids[0] == ids[1] and len(set(ids.tolist())) == 3
    lists = {tuple(out[off[i]:off[i + 1]].tolist()) for i in range(3)}
    assert lists == {(1, 2), (1,), (2, 1)}
