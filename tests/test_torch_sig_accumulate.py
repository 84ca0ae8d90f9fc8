"""K3 and A1 of the port as their CUDA kernels compute them, on the CPU.

(a) A numpy model of K3 (``csrc/sig.cu``): each lane's windows in the
kernel's layout, run heads against the window before (from the lane before,
or lane 31's previous group), then either the heads one to a lane through a
32-wide bitonic network (H <= 32) or the whole row through the register
network (H > 32), duplicates dropped against the left neighbour. It is held
against the JAX package's ``read_signatures`` (XLA) and its Pallas kernel in
interpret mode, and the port's plain version, on the rows of
``tests/synthetic_signatures.py``.

(b) A1 (``csrc/accumulate.cu``) audits only the reads that matched an
existing key: a winner's slot holds its own row. On the port's plain
claim (``map.signature.claim_slots``, which the kernel mirrors), over
seeded batches and tables pre-seeded with a forced fingerprint collision,
every winner's stored row is its own, and the collisions counted over the
matchers alone equal the audit of every resolved read, the port's
``fold_batch`` and the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import seekmer_tpu.map.signature as jsig
import seekmer_tpu_torch.map.signature as tsig
from seekmer_tpu.ops.sig_pallas import read_signatures_pallas
from tests.synthetic_signatures import adversarial_rows, seed_collision

torch.set_num_threads(1)
PAD = tsig.SIG_PAD
NONE = -1


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _bitonic(x):
    """Ascending bitonic network over the last axis (a power of two), as
    the kernel runs it: element i against i ^ stride, ascending where
    (i & size) == 0."""
    x = x.copy()
    n = x.shape[-1]
    i = np.arange(n)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            y = x[..., i ^ stride]
            up = (i & size) == 0
            lower = (i & stride) == 0
            x = np.where(lower == up, np.minimum(x, y), np.maximum(x, y))
            stride //= 2
        size *= 2
    return x


def k3_model(ecs, valid, C):
    """(sig int32[B, C], mapped bool[B], heads int[B]) as K3 computes them."""
    B, P = ecs.shape
    G = 4 if P % 4 == 0 else 1  # 16-byte groups or one window a load
    NV = max(4, _next_pow2(-(-P // 32)))
    lane = np.arange(32)[:, None]
    k = np.arange(NV)[None, :]
    pos = (k // G) * 32 * G + lane * G + k % G  # window of value k, lane l
    x = np.where(valid & (ecs >= 0), ecs, PAD).astype(np.int64)
    sig = np.full((B, C), PAD, np.int64)
    mapped = np.zeros(B, bool)
    heads = np.zeros(B, int)
    for b in range(B):
        v = np.full((32, NV), PAD, np.int64)
        inb = pos < P
        v[inb] = x[b, pos[inb]]
        prev = np.full((32, NV), NONE, np.int64)
        for kk in range(NV):
            if kk % G:
                prev[:, kk] = v[:, kk - 1]
            else:
                last = v[:, kk + G - 1]
                prev[1:, kk] = last[:-1]  # __shfl_up_sync
                if kk:
                    prev[0, kk] = v[31, kk - 1]  # lane 31, previous group
        is_head = (v != PAD) & (v != prev)
        H = int(is_head.sum())
        heads[b] = H
        if H <= 32:
            # lane by lane, k ascending within a lane, as the scan places them
            lanes = np.full(32, PAD, np.int64)
            lanes[:H] = v[is_head]
            s = _bitonic(lanes)
        else:
            s = _bitonic(np.where(is_head, v, PAD).reshape(-1))
        left = np.r_[NONE, s[:-1]]
        fresh = (s != PAD) & (s != left)
        d = s[fresh]
        n = d.size
        sig[b, :min(n, C)] = d[:C]
        mapped[b] = 1 <= n <= C
    return sig.astype(np.int32), mapped, heads


@pytest.mark.parametrize("P,C", [
    (208, 16),  # config 2: two mates of 104 windows, W 256
    (104, 16),  # config 1
    (976, 16),  # a paired 512-bp row, W 1,024
    (1024, 16),  # the widest row
    (101, 16),  # P not a multiple of 4 or 32: one window a load
    (30, 5),  # P < 32, not a multiple of 4
    (3, 8),  # P < C
    (64, 40),  # C > 32
])
def test_k3_model_matches_jax(P, C):
    ecs, valid = adversarial_rows(P, C, seed=P + C)
    sig, mapped, heads = k3_model(ecs, valid, C)
    js, jm = jsig.read_signatures(jnp.asarray(ecs), jnp.asarray(valid), C)
    np.testing.assert_array_equal(sig, np.asarray(js))
    np.testing.assert_array_equal(mapped, np.asarray(jm))
    ps, pm = read_signatures_pallas(jnp.asarray(ecs), jnp.asarray(valid), C,
                                    block=8, interpret=True)
    np.testing.assert_array_equal(sig, np.asarray(ps))
    np.testing.assert_array_equal(mapped, np.asarray(pm))
    ts, tm = tsig.read_signatures(torch.from_numpy(ecs),
                                  torch.from_numpy(valid), C)
    np.testing.assert_array_equal(sig, ts.numpy())
    np.testing.assert_array_equal(mapped, tm.numpy())
    assert mapped.any() and not mapped.all()
    if P >= 34:  # both paths, and both sides of the edge, were taken
        assert {31, 32, 33, 34} <= set(heads.tolist())
        assert heads.max() == P and heads.min() == 0


def test_k3_model_heads_on_simulated_pairs():
    """On run-structured rows like a read pair's (runs of one EC broken by
    junctions and misses), nearly every read has at most 32 heads."""
    rng = np.random.default_rng(3)
    B, P = 256, 208
    ecs = np.empty((B, P), np.int32)
    for b in range(B):
        n_cuts = int(rng.integers(0, 6))
        cuts = np.sort(rng.choice(np.arange(1, P), size=n_cuts, replace=False))
        vals = rng.integers(0, 50, size=cuts.size + 1)
        ecs[b] = np.repeat(vals, np.diff(np.r_[0, cuts, P]))
    ecs[rng.random((B, P)) < 0.02] = -1
    valid = np.ones((B, P), bool)
    valid[:, 76:104] = valid[:, 180:] = False  # each mate's padded tail
    sig, mapped, heads = k3_model(ecs, valid, 16)
    want = tsig.read_signatures(torch.from_numpy(ecs), torch.from_numpy(valid),
                                16)
    np.testing.assert_array_equal(sig, want[0].numpy())
    np.testing.assert_array_equal(mapped, want[1].numpy())
    assert (heads <= 32).mean() > 0.9


def _seeded_table(bits, C, num_ecs, collide_with):
    """Table fields as numpy arrays, with ``collide_with``'s key seeded
    (``seed_collision``) unless it is None; the fields both packages'
    tables have (the port's count of complex reads is its own)."""
    t = tsig.make_sig_table(bits, C, num_ecs=num_ecs, device="cpu")
    if collide_with is not None:
        seed_collision(t, torch.from_numpy(collide_with))
    return {f: getattr(t, f).numpy() for f in tsig.SigTable._fields
            if f != "complex"}


def _batch(rng, B, C, X):
    pool = np.full((40, C), PAD, np.int32)
    for i in range(40):
        n = int(rng.integers(1, 5))
        pool[i, :n] = np.sort(rng.choice(30, size=n, replace=False))
    sig = pool[rng.integers(0, 40, size=B)]
    sig[rng.random(B) < 0.1] = X
    return sig, rng.random(B) < 0.9, rng.integers(0, 3, size=B).astype(
        np.int32)


@pytest.mark.parametrize("bits,num_ecs,collide", [
    (10, 40, False),
    (10, 40, True),  # direct vector + a pre-seeded collision
    (10, 0, True),  # every row through the fingerprint table
    (7, 40, True),  # a crowded table
])
def test_audit_of_matchers_alone(bits, num_ecs, collide):
    rng = np.random.default_rng(bits + num_ecs + collide)
    C = 8
    X = np.full(C, PAD, np.int32)
    X[:3] = [3, 11, 17]
    fields = _seeded_table(bits, C, num_ecs, X if collide else None)
    port = tsig.sig_table_from_numpy(fields, "cpu")
    jt = jsig.SigTable(**{f: jnp.asarray(fields[f]) for f in fields})
    total = 0
    for _ in range(3):
        sig, mapped, w = _batch(rng, 300, C, X)
        # the claim on a copy, split as accumulate_direct splits the batch
        scratch = tsig.sig_table_from_numpy(
            {f: getattr(port, f).numpy() for f in tsig.SigTable._fields},
            "cpu")
        s, m, wt = (torch.from_numpy(a) for a in (sig, mapped, w))
        wm = tsig._weights(m, wt)
        if num_ecs:
            single = (wm > 0) & (s[:, 0] != PAD) & (s[:, 1] == PAD)
            wm = torch.where(single, 0, wm)
        slot, won, _ = tsig.claim_slots(scratch, s, wm, 32)
        scratch.sig[slot[won]] = s[won]
        resolved = slot >= 0
        assert torch.equal(scratch.sig[slot[won]], s[won])
        differ = (scratch.sig[slot.clamp(min=0)] != s).any(dim=1) & resolved
        every = int(wm[differ].sum())
        matchers = int(wm[differ & ~won].sum())
        assert matchers == every
        before = (int(port.collisions), int(jt.collisions))
        tsig.fold_batch(port, s, m, weights=wt)
        jt = jsig.fold_batch(jt, jnp.asarray(sig), jnp.asarray(mapped),
                             weights=jnp.asarray(w))
        assert int(port.collisions) - before[0] == matchers
        assert int(jt.collisions) - before[1] == matchers
        total += matchers
    assert (total > 0) == collide
    assert int(port.overflow) == int(jt.overflow) == 0
