"""The port's signature table (seekmer_tpu_torch.map.signature) against the
JAX package's: the same batches of signatures fold into both tables, and
the merged host output (``merge_sig_rows``), overflow and collision counts
must be equal. Raw slots are not compared: placement under contested
claims is not part of the contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import seekmer_tpu.map.signature as jsig
import seekmer_tpu_torch.map.signature as tsig
from seekmer_tpu.config import MapConfig
from seekmer_tpu.io.fastq import ReadBatch
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.utils.simulate import simulate_packed_batches
from seekmer_tpu_torch.map.driver import Mapper, merge_sig_rows
from seekmer_tpu_torch.ops import accumulate_cuda
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)
PAD = tsig.SIG_PAD


def _random_sigs(rng, B, C, n_distinct, max_ec=30):
    """Rows drawn from n_distinct signatures of 1..4 sorted distinct ECs."""
    pool = np.full((n_distinct, C), PAD, np.int32)
    for i in range(n_distinct):
        n = int(rng.integers(1, 5))
        pool[i, :n] = np.sort(rng.choice(max_ec, size=n, replace=False))
    rows = pool[rng.integers(0, n_distinct, size=B)]
    mapped = rng.random(B) < 0.9
    weights = (rng.random(B) < 0.95).astype(np.int32)
    return rows, mapped, weights


def _merged(sigs, counts, overflow, collisions):
    return merge_sig_rows(sigs, counts.astype(np.int64), 0, overflow,
                          collisions)


def _assert_same(jt, tt):
    a = _merged(*jsig.table_to_host(jt), int(jt.overflow),
                int(jt.collisions))
    b = _merged(*tsig.table_to_host(tt), int(tt.overflow),
                int(tt.collisions))
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.overflow, a.collisions) == (b.overflow, b.collisions)
    return b


@pytest.mark.parametrize("bits,num_ecs,n_distinct", [
    (10, 40, 60),   # direct vector + CAS, room to spare
    (10, 0, 60),    # placeholder ec_count: every row through the CAS
    (4, 40, 200),   # 16 slots for ~150 multi-EC signatures: overflow
])
def test_fold_batch_matches_jax(bits, num_ecs, n_distinct):
    rng = np.random.default_rng(bits * 100 + n_distinct)
    C = 8
    jt = jsig.make_sig_table(bits, C, num_ecs=num_ecs)
    tt = tsig.make_sig_table(bits, C, num_ecs=num_ecs, device="cpu")
    for batch in range(3):
        sig, mapped, w = _random_sigs(rng, 256, C, n_distinct)
        audit = batch != 1
        jt = jsig.fold_batch(jt, jnp.asarray(sig), jnp.asarray(mapped),
                             weights=jnp.asarray(w), sig_probe=8,
                             audit=audit)
        tt = accumulate_cuda.fold_batch(
            tt, torch.from_numpy(sig), torch.from_numpy(mapped),
            weights=torch.from_numpy(w), sig_probe=8, audit=audit)
    res = _assert_same(jt, tt)
    assert res.sig_counts.sum() > 0
    if bits == 4:
        assert res.overflow > 0


def _forced_collision_run(mod, as_array, const_fp, monkeypatch, **table):
    """The forced-collision sequence of the JAX package's
    test_collision_audit_detects_forced_collision, on module ``mod``
    (``table``: further arguments of its ``make_sig_table``). Returns the
    (collisions, counts) observed after each step."""
    monkeypatch.setattr(mod, "fingerprint", const_fp)
    C = 4
    sig1 = np.full((2, C), PAD, np.int32)
    sig1[:, 0] = 3
    sig2 = np.full((2, C), PAD, np.int32)
    sig2[:, 0] = 5
    mapped = as_array(np.array([True, True]))
    seen = []

    def note(t):
        seen.append((int(t.collisions),
                     sorted(mod.table_to_host(t)[1].tolist())))

    t = mod.make_sig_table(bits=4, max_ecs=C, **table)
    t = mod.accumulate(t, as_array(sig1), mapped)
    note(t)
    t = mod.accumulate(t, as_array(sig2), mapped)
    note(t)
    # same-batch double claim
    t2 = mod.make_sig_table(bits=4, max_ecs=C, **table)
    t2 = mod.accumulate(t2, as_array(np.stack([sig1[0], sig2[0]])), mapped)
    note(t2)
    # audit off: undetected
    t3 = mod.make_sig_table(bits=4, max_ecs=C, **table)
    t3 = mod.accumulate(t3, as_array(sig1), mapped)
    t3 = mod.accumulate(t3, as_array(sig2), mapped, audit=False)
    note(t3)
    return seen


def test_collision_audit_detects_forced_collision(monkeypatch):
    """Two distinct signatures forced onto one fingerprint: the audit counts
    the reads whose counts merged into the other signature's row, as the
    JAX table does."""
    def j_fp(sig):
        B = sig.shape[0]
        return jnp.full((B,), 7, jnp.int32), jnp.full((B,), 9, jnp.int32)

    def t_fp(sig):
        B = sig.shape[0]
        return (torch.full((B,), 7, dtype=torch.int32),
                torch.full((B,), 9, dtype=torch.int32))

    want = _forced_collision_run(jsig, jnp.asarray, j_fp, monkeypatch)
    got = _forced_collision_run(tsig, torch.from_numpy, t_fp, monkeypatch,
                                device="cpu")
    assert got == want
    assert got == [(0, [2]), (2, [4]), (1, [2]), (0, [4])]


def test_fingerprint_matches_jax():
    rng = np.random.default_rng(11)
    sig, _, _ = _random_sigs(rng, 512, 16, 300, max_ec=1 << 20)
    sig[0] = 0
    f1, f2 = jsig.fingerprint(jnp.asarray(sig))
    g1, g2 = tsig.fingerprint(torch.from_numpy(sig))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(f2))


def test_sig_table_from_numpy_mid_run():
    """A JAX table carried into the port after one batch: the port's Mapper
    finishes the run with the same MapResult as the JAX Mapper."""
    from __graft_entry__ import _tiny_world

    rng, index, seqs = _tiny_world()
    B, L = 128, 96
    codes, _ = simulate_packed_batches(rng, seqs, 3, B, read_len=L,
                                       error_rate=0.01)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    w[-5:] = 0  # pad rows
    batches = [ReadBatch(codes[i], lengths, w) for i in range(3)]
    cfg = MapConfig(batch_size=B, sig_table_bits=10, collision_audit_every=2)
    jm = JMapper(index, cfg)
    jm.feed(batches[0])
    fields = {f: np.asarray(getattr(jm.table, f))
              for f in jm.table._fields}
    tm = Mapper(port_index(index), port_config(cfg), device="cpu")
    tm.table = tsig.sig_table_from_numpy(fields, "cpu")
    tm.total_reads, tm._fed_batches = jm.total_reads, jm._fed_batches
    for b in batches[1:]:
        jm.feed(b)
        tm.feed(b)
    a, b = jm.finalize(), tm.finalize()
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.total_reads, a.mapped, a.overflow, a.collisions) == (
        b.total_reads, b.mapped, b.overflow, b.collisions)
    assert b.total_reads == 3 * (B - 5)
