"""Signature rows and EC CSRs that take I2 (``csrc/intersect.cu``) and
its plain version down each of their paths: no row, one row, rows of 2
and of 16 ECs, empty intersections (one empty only at its last EC), lists
longer than a warp's 32 candidates and longer than 1,024, and a random
world of gene families shaped like a paralog sample. Shared by the CPU
tests, the card's tests and ``chip_smoke.py``; no JAX here.
"""

from functools import reduce

import numpy as np

SIG_PAD = 0x7FFFFFFF


def csr(lists):
    """(ec_offsets, ec_transcripts), int32, of sorted unique lists."""
    lens = np.fromiter((len(m) for m in lists), np.int64, len(lists))
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    flat = (np.concatenate([np.asarray(m, np.int64) for m in lists])
            if lists else np.empty(0, np.int64))
    return off.astype(np.int32), flat.astype(np.int32)


def rows_of(sigs, C):
    """int32 (M, C) rows of sorted EC ids, SIG_PAD after them."""
    out = np.full((len(sigs), C), SIG_PAD, np.int32)
    for i, s in enumerate(sigs):
        out[i, :len(s)] = np.sort(s)
    return out


def reference(rows, offsets, transcripts):
    """Each row's intersection as the JAX package's loop computes it."""
    out = []
    for row in rows:
        ecs = row[row != SIG_PAD]
        lists = [transcripts[offsets[e]:offsets[e + 1]] for e in ecs]
        out.append(reduce(lambda a, b: np.intersect1d(a, b,
                                                      assume_unique=True),
                          lists) if lists else np.empty(0, np.int32))
    return out


def cases():
    """{name: (rows, ec_offsets, ec_transcripts)} of the fixed cases."""
    rng = np.random.default_rng(7)
    T = 5000

    def subset(n, keep=()):
        pick = rng.choice(T, size=n, replace=False)
        return np.unique(np.r_[pick, keep]).astype(np.int64)

    core = np.arange(0, 4000, 3)  # 1,334 ids every long list holds
    lists = [
        np.array([1, 5, 9]), np.array([5, 9, 11]), np.array([2, 5, 9]),
        np.array([3]), np.array([4, 6]), np.array([1, 5, 7, 9, 40]),
        subset(40, core[:20]), subset(70, core[:20]), subset(33, core[:20]),
        subset(1500, core), subset(1100, core), subset(2000, core),
        np.array([9]),
    ]
    lists += [np.unique(np.r_[np.arange(10, 30), rng.choice(T, 8)])
              for _ in range(16)]  # 16 lists sharing 10..29
    off, tr = csr(lists)
    C = 16
    return {
        "no_rows": (np.empty((0, C), np.int32), off, tr),
        "one_row": (rows_of([[0, 1]], C), off, tr),
        "two_ecs": (rows_of([[0, 1], [1, 2], [0, 2], [3, 4], [0, 5]], C),
                    off, tr),
        "sixteen_ecs": (rows_of([list(range(13, 29)),
                                 list(range(14, 29)) + [0]], C), off, tr),
        "empty": (rows_of([[3, 4], [0, 1, 3], [0, 1, 2, 5, 12],
                           [0, 1, 2, 5, 3]], C), off, tr),
        "over_32": (rows_of([[6, 7], [6, 7, 8], [7, 8]], C), off, tr),
        "over_1024": (rows_of([[9, 10], [9, 10, 11], [10, 11], [9, 6]], C),
                      off, tr),
    }


def paralog_like(rng, n_rows, C=16, genes_per_family=(2, 22),
                 ecs_per_family=(3, 12), ecs_per_row=(2, 5)):
    """(rows, ec_offsets, ec_transcripts) of ``n_rows`` signatures over a
    world of gene families: each family a block of transcripts, each of its
    ECs a random subset of the block that holds the block's first
    transcript nine times in ten, each row 2-5 distinct ECs of one family.
    At 69,700 rows: ~1.5M list members, as a paralog sample's ~69,700
    multi-EC signatures have."""
    n_fam = max(n_rows // 8, 1)
    size = rng.integers(*genes_per_family, endpoint=True, size=n_fam)
    first = np.zeros(n_fam, np.int64)
    np.cumsum(size[:-1], out=first[1:])
    n_ecs = rng.integers(*ecs_per_family, endpoint=True, size=n_fam)
    lists = []
    for f in range(n_fam):
        block = np.arange(first[f], first[f] + size[f])
        for _ in range(n_ecs[f]):
            m = rng.random(size[f]) < rng.random()
            m[0] = m[0] or rng.random() < 0.9
            if not m.any():
                m[rng.integers(size[f])] = True
            lists.append(block[m])
    off, tr = csr(lists)
    ec_first = np.zeros(n_fam, np.int64)
    np.cumsum(n_ecs[:-1], out=ec_first[1:])
    fam = rng.integers(n_fam, size=n_rows)
    k = np.minimum(rng.integers(*ecs_per_row, endpoint=True, size=n_rows),
                   n_ecs[fam])
    # k distinct ECs of the row's family: the first k of a random order
    most = ecs_per_family[1]
    cols = np.arange(most)
    keys = np.where(cols[None, :] < n_ecs[fam][:, None],
                    rng.random((n_rows, most)), 2.0)
    local = np.argsort(keys, axis=1)
    ids = np.where(cols[None, :] < k[:, None], ec_first[fam][:, None] + local,
                   SIG_PAD)
    rows = np.full((n_rows, max(C, most)), SIG_PAD, np.int64)
    rows[:, :most] = np.sort(ids, axis=1)
    return rows[:, :C].astype(np.int32), off, tr
