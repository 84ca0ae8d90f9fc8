"""Window rows that take K3 (``csrc/sig.cu``) down each of its paths.

K3 sorts only the heads of a read's runs of equal EC ids when there are at
most 32, and the whole row in registers when there are more. These rows sit
on and around that edge and on the masking rules: long runs, exactly 32 and
33 heads, an id that recurs after a miss (two heads, one id), ids -2 and -1
(misses), all-invalid rows, exactly C and C + 1 distinct ids, every window a
head, the largest id below SIG_PAD, and runs that cross the kernel's lane
and 16-byte group edges. Also a table pre-seeded with a colliding key for
A1's audit. Shared by the CPU tests, the card's tests and ``chip_smoke.py``;
no JAX here.
"""

import numpy as np
import torch

from seekmer_tpu_torch.map.signature import KB, fingerprint, sig_slot_hash

TOP_ID = 0x7FFFFFFE  # the largest EC id below SIG_PAD


def _runs(rng, P, values, cuts=None):
    """A row of P windows: values[i] repeated over the i-th run; runs are
    cut at ``cuts`` (sorted positions) or evenly."""
    n = len(values)
    if cuts is None:
        cuts = np.linspace(0, P, n + 1).astype(int)[1:-1]
    lens = np.diff(np.r_[0, cuts, P])
    return np.repeat(np.asarray(values, np.int64), lens)[:P]


def adversarial_rows(P: int, C: int, seed: int):
    """(ecs int32[B, P], valid bool[B, P]) of the cases above, at any P >= 1
    (cases that need more windows than P are cut to P)."""
    rng = np.random.default_rng(seed)
    rows, valids = [], []

    def add(row, valid=None):
        row = np.asarray(row, np.int64)
        if row.size < P:  # too short: repeat the last window's id
            row = np.r_[row, np.full(P - row.size, row[-1] if row.size
                                     else -1)]
        rows.append(row[:P])
        valids.append(np.ones(P, bool) if valid is None else valid[:P])

    ids = rng.permutation(max(10 * C, P) + 64)
    add(_runs(rng, P, ids[:3]))  # long runs
    add(_runs(rng, P, ids[:1]))  # one id
    for h in (31, 32, 33, 34):  # heads around the edge, alternating ids
        add(_runs(rng, P, [ids[i % 2] for i in range(h)]))
        add(_runs(rng, P, ids[:h]))  # as many distinct ids as heads
    # an id recurring after a miss, and after another id
    add(np.r_[[ids[0]] * 5, [-1] * 3, [ids[0]] * 5, [ids[1]] * 4,
              [ids[0]] * 9])
    add(_runs(rng, P, [ids[0], -2, ids[0], -1, ids[1], -2]))  # -2 and -1
    add(np.full(P, -1))  # all misses
    add(_runs(rng, P, ids[:5]), np.zeros(P, bool))  # all invalid
    for n in (C - 1, C, C + 1):  # around the signature's capacity
        add(_runs(rng, P, ids[:max(n, 1)]))
    add(_runs(rng, P, [TOP_ID, 0, TOP_ID - 1]))
    add(np.arange(P) % (3 * C) + 1)  # every window a head
    add(ids[:P])  # every window a distinct id
    # runs cut at the lane (4 windows) and 16-byte group (128) edges
    edges = [c for c in (3, 4, 5, 127, 128, 129, 255, 256) if c < P]
    add(_runs(rng, P, ids[:len(edges) + 1], cuts=np.array(edges, int)))
    for _ in range(12):  # random runs with misses and invalid windows
        n = int(rng.integers(1, min(P, 60) + 1))
        cuts = np.sort(rng.choice(np.arange(1, P), size=min(n - 1, P - 1),
                                  replace=False)) if P > 1 else np.array([])
        row = _runs(rng, P, rng.integers(-2, 3 * C, size=cuts.size + 1),
                    cuts=cuts.astype(int))
        row[rng.random(P) < 0.05] = -1
        add(row, rng.random(P) < 0.9)
    return (np.stack(rows).astype(np.int32), np.stack(valids))


def seed_collision(table, row) -> None:
    """Store ``row``'s fingerprint in slot 0 of its home bucket of an empty
    ``table`` beside another row (EC ids 1, 2), as if that row had claimed
    the slot under a colliding fingerprint: every later read of ``row``
    matches the key, and the audit must count it."""
    f1, f2 = fingerprint(row[None])
    home = int(sig_slot_hash(f1, f2)[0]) & (table.key.shape[0] - 2)
    table.key[home, 0, 0], table.key[home, 0, 1] = f1[0], f2[0]
    table.sig[home * KB, :2] = torch.tensor([1, 2], device=row.device)
    table.count[home * KB] = 5
