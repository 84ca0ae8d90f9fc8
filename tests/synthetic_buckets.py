"""Synthetic bucket tables for the lookup (K2) tests, numpy only.

Shared by ``test_torch_pack_lookup.py`` (the port's plain lookup against
the JAX package on the CPU) and ``test_torch_cuda.py`` (the kernel against
the plain lookup on the card, where JAX is absent).
"""

import numpy as np

from seekmer_tpu_torch.ops.hash import hash_kmer_np, hash_kmer_stash_np

EMPTY_ROW = (-1, -1, -1, -1)


def hi_collision_tables(G: int, nb: int = 16, nb_s: int = 8, seed: int = 0):
    """Host main and stash tables (rows [hi, lo, ec, aux], ``G`` slots a
    bucket) built around four keys whose home rows hold slots that share
    the key's hi but not its lo:

    - A: up to two such slots, then A itself in the row's last slot: found;
    - B: a full home row with one such slot; B lives in the stash (behind a
      hi-only slot there too): found in the stash;
    - C (G >= 2): a home row with one such slot and an empty slot; C is in
      the stash as well, but the stash is consulted only for full rows, so
      C stays MISS;
    - D: a full home row with one such slot, and no stash entry: MISS.

    Filler keys take hi values no query uses. Returns (table, stash,
    queries) with queries a list of (name, hi, lo, valid, (ec, aux)
    expected or None), random absent keys and an invalid copy of A
    included.
    """
    rng = np.random.default_rng(seed)
    names = ["A", "B", "C", "D"] if G >= 2 else ["A", "B", "D"]
    while True:  # keys with distinct home rows and distinct stash rows
        hi = rng.integers(0, 1 << 24, len(names)).astype(np.uint32)
        lo = rng.integers(0, 1 << 26, len(names)).astype(np.uint32)
        home = hash_kmer_np(hi, lo) & np.uint32(nb - 1)
        srow = hash_kmer_stash_np(hi, lo) & np.uint32(nb_s - 1)
        if len(set(home.tolist())) == len(names) and len(
                set(srow.tolist())) == len(names):
            break
    key = {n: (int(h), int(l), int(b), int(s))
           for n, h, l, b, s in zip(names, hi, lo, home, srow)}

    def filler():
        return (int(rng.integers(1 << 24, 1 << 25)),
                int(rng.integers(0, 1 << 26)), int(rng.integers(0, 5000)),
                int(rng.integers(0, 200)))

    table = np.full((nb, G, 4), -1, np.int64)
    stash = np.full((nb_s, G, 4), -1, np.int64)
    for b in range(nb):  # other rows: 0 to G fillers
        for s in range(int(rng.integers(0, G + 1))):
            table[b, s] = filler()
    for n, (h, l, b, sb) in key.items():
        table[b] = [filler() for _ in range(G)]
        if n == "A":
            nd = min(2, G - 1)
            for i, s in enumerate(range(G - 1 - nd, G - 1)):
                table[b, s] = (h, l ^ (i + 1), 100 + i, 5)
            table[b, G - 1] = (h, l, 4242, 17)
        else:
            table[b, 0] = (h, l ^ 1, 300, 9)
        if n == "C":
            table[b, 1] = EMPTY_ROW
        if n in ("B", "C"):
            stash[sb, G - 1] = (h, l, 777 if n == "B" else 888, 3)
            if G >= 2:
                stash[sb, 0] = (h, l ^ 2, 999, 1)

    queries = [(n, key[n][0], key[n][1], True,
                {"A": (4242, 17), "B": (777, 3)}.get(n, (-1, 0)))
               for n in names]
    queries.append(("A invalid", key["A"][0], key["A"][1], False, (-1, 0)))
    for h, l in zip(rng.integers(0, 1 << 24, 64), rng.integers(0, 1 << 26, 64)):
        queries.append(("absent", int(h), int(l), True, None))
    return (table.reshape(nb * G, 4).astype(np.int32),
            stash.reshape(nb_s * G, 4).astype(np.int32), queries)


def query_lanes(queries):
    """(hi int32[N], lo int32[N], valid bool[N]) of the queries."""
    return (np.array([q[1] for q in queries], np.int32),
            np.array([q[2] for q in queries], np.int32),
            np.array([q[3] for q in queries], bool))


def check_expected(queries, ec, aux):
    for (name, _, _, _, want), e, a in zip(queries, ec, aux):
        if want is not None:
            assert (int(e), int(a)) == want, name
