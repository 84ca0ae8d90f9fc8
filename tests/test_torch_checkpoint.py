"""Checkpoints and resume in the port against the JAX package, on the CPU:
the checkpointable batch source's batches and cursors, offset resume that
never re-reads consumed input, checkpoint files carried between the two
packages, EM and bootstrap interrupted at their first snapshot and resumed
bit for bit, the quantifier's snapshot lifecycle, and reads held in memory
(``batch_reads``, ``Quantifier.quantify_reads``)."""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io import fastq as jfastq
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.map.signature import SIG_PAD
from seekmer_tpu.models.quantifier import Quantifier as JQuantifier
from seekmer_tpu.utils import checkpoint as jckpt
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
from seekmer_tpu_torch.em import bootstrap as tbootstrap
from seekmer_tpu_torch.em.bootstrap import run_bootstrap
from seekmer_tpu_torch.em.em import build_ec_table, run_em
from seekmer_tpu_torch.io import fastq as tfastq
from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)

# est_counts of float32 EM, port against the JAX package: the bound of
# tests/test_torch_pipeline.py's Quantifier parity
RTOL, ATOL = 5e-3, 5e-2


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    names, seqs = random_transcriptome(rng, num_transcripts=30,
                                       shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100)
    pairs = simulate_reads(rng, seqs, num_reads=500, read_len=100,
                           paired=True, mean_frag=180.0, sd_frag=15.0)
    return index, [r.encode() for r in sim.reads1], pairs


def _write_fastq(path, reads):
    text = "".join(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n"
                   for i, r in enumerate(reads))
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write(text)


def _as_dict(res):
    return {tuple(r[r != int(SIG_PAD)].tolist()): int(n)
            for r, n in zip(res.sigs, res.sig_counts)}


def _inputs(kind, tmp_path, world):
    """(paths, mate paths or None, JAX MapConfig) of one input layout."""
    _, reads, pairs = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    if kind in ("plain", "gz"):
        fq = str(tmp_path / ("reads.fq" + (".gz" if kind == "gz" else "")))
        _write_fastq(fq, reads)
        return [fq], None, cfg
    if kind == "paired":
        fq1, fq2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
        _write_fastq(fq1, [r.encode() for r in pairs.reads1])
        _write_fastq(fq2, [r.encode() for r in pairs.reads2])
        return [fq1], [fq2], dataclasses.replace(cfg, paired_end=True)
    if kind == "multifile":
        files = []
        for i in range(3):
            p = str(tmp_path / f"part{i}.fq")
            _write_fastq(p, reads[i * 200:(i + 1) * 200])
            files.append(p)
        return files, None, cfg
    assert kind == "mixed"  # several length buckets, pending rows in each
    rng = np.random.default_rng(3)
    fq = str(tmp_path / "mixed.fq")
    _write_fastq(fq, [r[: int(rng.integers(60, 101))] for r in reads])
    return [fq], None, dataclasses.replace(cfg, batch_size=64)


KINDS = ["plain", "gz", "paired", "multifile", "mixed"]


def _source(pkg, paths, mates, cfg, chunk=256):
    mod = jfastq if pkg == "jax" else tfastq
    src = mod.CheckpointableBatchSource(
        paths, mates, cfg if pkg == "jax" else port_config(cfg))
    src.CHUNK = chunk
    return src


@pytest.mark.parametrize("kind", KINDS)
def test_checkpointable_source_matches_jax(tmp_path, world, kind):
    """The same batches and the same cursors (offsets, pending rows) as
    the JAX package's, CHUNK 256."""
    paths, mates, cfg = _inputs(kind, tmp_path, world)
    want = list(_source("jax", paths, mates, cfg))
    got = list(_source("port", paths, mates, cfg))
    assert len(got) == len(want) > 2
    with_cursor = 0
    for g, w in zip(got, want):
        for f in ("codes", "lengths", "weights", "codes2", "lengths2"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert (g.cursor is None) == (w.cursor is None)
        if w.cursor is None:
            continue
        with_cursor += 1
        for k in ("v", "paired", "s1", "s2"):
            assert g.cursor[k] == w.cursor[k], k
        assert sorted(g.cursor["pending"]) == sorted(w.cursor["pending"])
        for bucket, d in w.cursor["pending"].items():
            assert sorted(g.cursor["pending"][bucket]) == sorted(d)
            for name, arr in d.items():
                np.testing.assert_array_equal(
                    g.cursor["pending"][bucket][name], arr)
    assert with_cursor >= 2
    if kind == "mixed":
        assert any(b.cursor and b.cursor["pending"] for b in got)
    if kind == "multifile":
        assert {b.cursor["s1"][0] for b in got if b.cursor} >= {1, 2}


def _interrupt(mapper, src, ckpt, after=2):
    """Feed until a cursor-bearing batch at or past ``after``, save there;
    returns the saved cursor."""
    for n, b in enumerate(src, 1):
        mapper.feed(b)
        if n >= after and b.cursor is not None:
            mapper.save_checkpoint(ckpt, stream_state=b.cursor)
            return b.cursor
    raise AssertionError("no cursor-bearing batch to save at")


@pytest.mark.parametrize("kind", KINDS)
def test_offset_resume_never_rereads(tmp_path, world, kind):
    """Interrupt after a checkpoint, corrupt every consumed byte of plain
    inputs, resume in a fresh port Mapper: the uninterrupted port run's
    MapResult and the JAX run's."""
    index, _, _ = world
    paths, mates, cfg = _inputs(kind, tmp_path, world)
    tcfg, tindex = port_config(cfg), port_index(index)
    ckpt = str(tmp_path / "map.ckpt.npz")
    want = JMapper(index, cfg).run(iter(_source("jax", paths, mates, cfg)))
    full = Mapper(tindex, tcfg, device="cpu").run(
        iter(_source("port", paths, mates, cfg)))

    saved = _interrupt(Mapper(tindex, tcfg, device="cpu"),
                       _source("port", paths, mates, cfg), ckpt)
    if kind in ("plain", "multifile", "mixed"):
        f, off = saved["s1"]
        assert off > 0 or f > 0
        for i, p in enumerate(paths[: f + 1]):
            n = os.path.getsize(p) if i < f else off
            with open(p, "r+b") as fh:
                fh.write(b"X" * n)

    m2 = Mapper(tindex, tcfg, device="cpu")
    src2 = _source("port", paths, mates, cfg)
    state = m2.restore_checkpoint(ckpt)
    assert state["s1"] == saved["s1"] and state["paired"] == (mates
                                                             is not None)
    src2.restore(state)
    res = m2.run(iter(src2))
    for other in (full, want):
        assert _as_dict(res) == _as_dict(other)
        assert (res.total_reads, res.mapped, res.overflow,
                res.collisions) == (other.total_reads, other.mapped,
                                    other.overflow, other.collisions)
    assert res.complex_reads == full.complex_reads


def test_jax_checkpoint_restores_in_port(tmp_path, world):
    """A checkpoint the JAX Mapper saved mid-stream, restored in the port,
    which maps the rest: JAX's final MapResult."""
    index, _, _ = world
    paths, mates, cfg = _inputs("paired", tmp_path, world)
    ckpt = str(tmp_path / "jax.ckpt.npz")
    want = JMapper(index, cfg).run(iter(_source("jax", paths, mates, cfg)))
    _interrupt(JMapper(index, cfg), _source("jax", paths, mates, cfg), ckpt)

    m = Mapper(port_index(index), port_config(cfg), device="cpu")
    src = _source("port", paths, mates, cfg)
    src.restore(m.restore_checkpoint(ckpt))
    got = m.run(iter(src))
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.total_reads, got.mapped, got.overflow, got.collisions) == (
        want.total_reads, want.mapped, want.overflow, want.collisions)


def test_port_checkpoint_loads_in_jax(tmp_path, world):
    """A checkpoint the port saved loads in the JAX package with equal
    arrays and cursor, and the JAX Mapper resumes from it to its own
    uninterrupted result."""
    index, _, _ = world
    paths, mates, cfg = _inputs("mixed", tmp_path, world)
    ckpt = str(tmp_path / "port.ckpt.npz")
    m = Mapper(port_index(index), port_config(cfg), device="cpu")
    saved = _interrupt(m, _source("port", paths, mates, cfg), ckpt, after=3)
    assert saved["pending"]
    table, total, cursor = jckpt.load_map_checkpoint(ckpt)
    assert total == m.total_reads
    for f in table._fields:
        np.testing.assert_array_equal(np.asarray(getattr(table, f)),
                                      getattr(m.table, f).numpy(), err_msg=f)
    assert cursor["s1"] == saved["s1"]
    for bucket, d in saved["pending"].items():
        for name, arr in d.items():
            np.testing.assert_array_equal(cursor["pending"][bucket][name],
                                          arr)
    want = JMapper(index, cfg).run(iter(_source("jax", paths, mates, cfg)))
    jm = JMapper(index, cfg)
    src = _source("jax", paths, mates, cfg)
    src.restore(jm.restore_checkpoint(ckpt))
    assert _as_dict(jm.run(iter(src))) == _as_dict(want)


def test_old_format_and_multiprocess_checkpoints_rejected(tmp_path):
    path = str(tmp_path / "old.ckpt")
    meta = dict(format=2, total_reads=5, stream_state={})
    with open(path, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            key=np.zeros((17, 2), np.int32), count=np.zeros(17, np.int32),
            sig=np.zeros((17, 4), np.int32), overflow=np.zeros((), np.int32))
    with pytest.raises(ValueError, match="format"):
        tckpt.load_map_checkpoint(path, "cpu")
    from seekmer_tpu_torch.map.signature import make_sig_table

    table = make_sig_table(4, 4, device="cpu")
    tckpt.save_map_checkpoint(path, table, -1, None, step=3)
    with pytest.raises(ValueError, match="multi-process"):
        tckpt.load_map_checkpoint(path, "cpu")
    assert tckpt.load_map_checkpoint(str(tmp_path / "nope"), "cpu") is None


def test_complex_count_round_trip(tmp_path):
    """The table's count of complex reads is saved and restored; a file
    without it (the JAX package's, or an older port's) restores 0."""
    from seekmer_tpu_torch.map.signature import SigTable, make_sig_table

    path = str(tmp_path / "c.ckpt.npz")
    table = make_sig_table(4, 4, device="cpu")
    table.complex.fill_(7)
    table.overflow.fill_(2)
    tckpt.save_map_checkpoint(path, table, 11, None)
    got, total, _, _ = tckpt.load_map_checkpoint(path, "cpu")
    assert total == 11 and int(got.complex) == 7 and int(got.overflow) == 2
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if k != "complex"}
    np.savez_compressed(path, **kept)
    got = tckpt.load_map_checkpoint(path, "cpu")[0]
    assert int(got.complex) == 0 and int(got.overflow) == 2
    assert set(got._fields) == set(SigTable._fields)


def test_adapt_ec_count(world):
    from seekmer_tpu_torch.map.signature import make_sig_table

    t = make_sig_table(4, 4, num_ecs=0, device="cpu")
    assert tckpt.adapt_ec_count(t, (7,)).ec_count.shape == (7,)
    bad = t._replace(ec_count=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="different index"):
        tckpt.adapt_ec_count(bad, (7,))


def _cpu_pipeline(**em):
    return PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12),
        em=EMConfig(rel_tol=1e-6, **em))


def test_cursorless_checkpoint_starts_fresh(tmp_path, world):
    """A checkpoint with no cursor cannot resume: the quantifier drops its
    table and starts fresh rather than count the consumed reads twice."""
    index, reads, _ = world
    cfg = port_config(_cpu_pipeline())
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    ckpt = str(tmp_path / "nocursor.ckpt.npz")
    m = Mapper(port_index(index), cfg.map, device="cpu")
    m.run(iter(tfastq.CheckpointableBatchSource([fq], cfg=cfg.map)))
    m.save_checkpoint(ckpt, stream_state=None)
    q = Quantifier(port_index(index), cfg, device="cpu")
    baseline = q.quantify_files([fq])
    resumed = q.quantify_files([fq], checkpoint_path=ckpt)
    assert resumed.total_reads == baseline.total_reads == 600
    assert resumed.mapped == baseline.mapped
    np.testing.assert_array_equal(resumed.est_counts, baseline.est_counts)


def test_quantifier_resumes_a_crashed_map_stage(tmp_path, world,
                                                monkeypatch):
    """quantify_files with a checkpoint every batch, crashed after batch
    2's save, resumed in a fresh Quantifier: the uninterrupted run's
    counts, fragment-length estimate (the checkpoint carries the FLD
    estimator's state) and est_counts bits; the JAX Quantifier's mapping
    and FLD exactly, est_counts within the pipeline bound."""
    index, _, _ = world
    paths, mates, mcfg = _inputs("paired", tmp_path, world)
    jcfg = PipelineConfig().replace(map=mcfg, em=EMConfig(rel_tol=1e-6))
    cfg = port_config(jcfg)
    ckpt = str(tmp_path / "q.ckpt.npz")
    tindex = port_index(index)
    full = Quantifier(tindex, cfg, device="cpu").quantify_files(
        paths, mates, checkpoint_path=str(tmp_path / "full.npz"),
        checkpoint_every=1)

    class Crash(Exception):
        pass

    real = Mapper.save_checkpoint
    saves = []

    def save_then_crash(self, path, stream_state=None):
        real(self, path, stream_state)
        saves.append(stream_state)
        if len(saves) == 2:
            raise Crash

    monkeypatch.setattr(Mapper, "save_checkpoint", save_then_crash)
    with pytest.raises(Crash):
        Quantifier(tindex, cfg, device="cpu").quantify_files(
            paths, mates, checkpoint_path=ckpt, checkpoint_every=1)
    monkeypatch.setattr(Mapper, "save_checkpoint", real)
    state = tckpt.load_map_checkpoint(ckpt, "cpu")[2]
    assert state["s1"] == saves[1]["s1"]
    got = Quantifier(tindex, cfg, device="cpu").quantify_files(
        paths, mates, checkpoint_path=ckpt, checkpoint_every=1)
    assert (got.total_reads, got.mapped, got.unmapped) == (
        full.total_reads, full.mapped, full.unmapped)
    assert got.fld_samples is not None
    assert (got.fld_mean, got.fld_sd, got.fld_samples) == (
        full.fld_mean, full.fld_sd, full.fld_samples)
    np.testing.assert_array_equal(got.est_counts, full.est_counts)
    want = JQuantifier(index, jcfg).quantify_files(paths, mates)
    assert (got.total_reads, got.mapped) == (want.total_reads, want.mapped)
    assert got.fld_samples == want.fld_samples
    # explicit fragment flags on a rerun: the checkpoint's FLD state is
    # not applied
    fixed = dataclasses.replace(cfg, em=dataclasses.replace(
        cfg.em, estimate_fld=False, mean_fragment_length=180.0))
    plain = Quantifier(tindex, fixed, device="cpu").quantify_files(paths,
                                                                  mates)
    again = Quantifier(tindex, fixed, device="cpu").quantify_files(
        paths, mates, checkpoint_path=ckpt)
    assert again.fld_samples is None and plain.fld_samples is None
    np.testing.assert_array_equal(again.est_counts, plain.est_counts)
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=RTOL,
                               atol=ATOL)


def _ec(world, dtype):
    index, reads, _ = world
    cfg = port_config(MapConfig(batch_size=128, sig_table_bits=12))
    tindex = port_index(index)
    result = Mapper(tindex, cfg, device="cpu").run(
        tfastq.batch_reads(reads, cfg))
    members, counts, _ = resolve_signatures(result, tindex)
    return tindex, build_ec_table(members, counts, index.num_transcripts,
                                  dtype=dtype, device="cpu")


class Boom(Exception):
    pass


def _crash_at_first_sync(fn):
    saves = []

    def on_sync(a, it):
        saves.append((a.copy(), it))
        raise Boom

    with pytest.raises(Boom):
        fn(on_sync)
    return saves[-1]


EM_CASES = [("f32", torch.float32, "none"), ("f64", torch.float64, "none"),
            ("squarem", torch.float32, "squarem")]


@pytest.mark.parametrize("name,dtype,accel", EM_CASES,
                         ids=[c[0] for c in EM_CASES])
def test_em_interrupt_resume_exact(world, name, dtype, accel):
    """EM stopped at its first snapshot and resumed from it: the
    uninterrupted run's bits and iteration count."""
    index, ec = _ec(world, dtype)
    cfg = port_config(EMConfig(rel_tol=1e-10, check_every=8, max_iters=400,
                               accel=accel))
    full, full_it = run_em(ec, index.lengths, cfg)
    assert full_it > cfg.check_every
    a0, it0 = _crash_at_first_sync(
        lambda f: run_em(ec, index.lengths, cfg, on_sync=f))
    assert 0 < it0 < full_it and a0.shape == (index.num_transcripts,)
    alpha, it = run_em(ec, index.lengths, cfg, alpha_init=a0, it_init=it0)
    assert it == full_it
    assert torch.equal(alpha, full)


@pytest.mark.parametrize("name,dtype,accel", EM_CASES,
                         ids=[c[0] for c in EM_CASES])
def test_bootstrap_interrupt_resume_exact(world, name, dtype, accel):
    """The batched CSR bootstrap stopped at its first snapshot and resumed:
    the same seeded count matrix and the uninterrupted bits."""
    index, ec = _ec(world, dtype)
    cfg = port_config(EMConfig(rel_tol=1e-10, check_every=8, max_iters=400,
                               accel=accel, bootstrap_samples=6,
                               bootstrap_seed=3, backend="csr"))
    full, full_it = run_bootstrap(ec, index.lengths, cfg)
    a0, it0 = _crash_at_first_sync(
        lambda f: run_bootstrap(ec, index.lengths, cfg, on_sync=f))
    assert a0.shape == (index.num_transcripts, 6) and 0 < it0 < full_it
    alpha, it = run_bootstrap(ec, index.lengths, cfg, alpha_init=a0,
                              it_init=it0)
    assert it == full_it
    assert torch.equal(alpha, full)


def test_pieces_replay_one_run(world, monkeypatch):
    """Pieces of one block each (the adaptive size pinned at one block):
    a snapshot at every block end, the one-run bits and count."""
    from seekmer_tpu_torch.em import em as tem

    index, ec = _ec(world, torch.float32)
    cfg = port_config(EMConfig(rel_tol=1e-10, check_every=8, max_iters=200))
    full, full_it = run_em(ec, index.lengths, cfg)
    monkeypatch.setattr(tem, "SYNC_TARGET_S", 0.0)
    seen = []
    alpha, it = run_em(ec, index.lengths, cfg,
                       on_sync=lambda a, i: seen.append(i))
    assert seen == list(range(8, full_it, 8))
    assert it == full_it and torch.equal(alpha, full)


def test_fresh_dense_route_ignores_on_sync(world):
    """A fresh run on the dense route (K4's plain version on the CPU)
    calls no snapshot hook, as the JAX Pallas path; a resumed one takes
    the CSR route and does."""
    index, ec = _ec(world, torch.float32)
    cfg = port_config(EMConfig(rel_tol=1e-10, check_every=8, max_iters=64,
                               backend="pallas", bootstrap_samples=4))
    calls = []
    run_em(ec, index.lengths, cfg, on_sync=lambda a, i: calls.append(i))
    run_bootstrap(ec, index.lengths, cfg, on_sync=lambda a, i: calls.append(i))
    assert calls == []
    a0 = np.full((index.num_transcripts, 4), 20.0, np.float32)
    run_bootstrap(ec, index.lengths, cfg, alpha_init=a0, it_init=8,
                  on_sync=lambda a, i: calls.append(i))
    assert calls and calls[0] == 16


def test_em_snapshot_roundtrip_across_packages(tmp_path):
    p = str(tmp_path / "em.npz")
    a = np.arange(5, dtype=np.float32)
    tckpt.save_em_snapshot(p, torch.from_numpy(a), 40)
    got = jckpt.load_em_snapshot(p)
    np.testing.assert_array_equal(got[0], a)
    assert got[1:] == (40, False)
    jckpt.save_em_snapshot(p, a, 48, converged=True)
    got = tckpt.load_em_snapshot(p)
    np.testing.assert_array_equal(got[0], a)
    assert got[1:] == (48, True)
    assert tckpt.load_em_snapshot(str(tmp_path / "none.npz")) is None


def test_stage_snapshots_one_process(tmp_path):
    """``StageSnapshots`` on one process: inert without a path; loads a
    snapshot, ignores one of another shape, throttles its hook, pins EM's
    end, gives a rank that is not the lead the lead's snapshot and writes
    nothing there, and deletes both files when the run is done."""
    T, B = 5, 3
    none = tckpt.StageSnapshots(None, T, B, True, lambda x: x)
    assert none.load("EM") == (None, 0, False)
    assert none.on_sync("bootstrap") is None
    none.pin(np.ones(T), 3, converged=True)
    none.done()
    ckpt = str(tmp_path / "run.ckpt.npz")
    snaps = tckpt.StageSnapshots(ckpt, T, B, True, lambda x: x)
    assert snaps.load("EM") == (None, 0, False)
    tckpt.save_em_snapshot(ckpt + ".em.npz", np.arange(T, dtype=np.float32),
                           12)
    alpha, it, conv = snaps.load("EM")
    np.testing.assert_array_equal(alpha, np.arange(T))
    assert (it, conv) == (12, False)
    tckpt.save_em_snapshot(ckpt + ".boot.npz", np.ones((T, B + 1)), 4)
    assert snaps.load("bootstrap") == (None, 0, False)
    sync = snaps.on_sync("bootstrap")
    sync(np.full((T, B), 2.0), 7)
    sync(np.full((T, B), 3.0), 9)  # within SNAPSHOT_MIN_INTERVAL_S
    alpha, it, _ = snaps.load("bootstrap")
    np.testing.assert_array_equal(alpha, np.full((T, B), 2.0))
    assert it == 7
    snaps.pin(np.full(T, 5.0), 20, converged=True)
    sent = []
    lead = tckpt.StageSnapshots(ckpt, T, B, True,
                                lambda x: sent.append(x) or x)
    other = tckpt.StageSnapshots(ckpt, T, B, False, lambda x: sent.pop(0))
    for stage in ("EM", "bootstrap"):
        want = lead.load(stage)
        got = other.load(stage)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert lead.load("EM")[1:] == (20, True)
    assert other.on_sync("EM") is None
    other.pin(np.zeros(T), 1, converged=False)
    other.done()
    assert lead.load("EM")[1:] == (20, True)
    snaps.done()
    assert not os.path.exists(ckpt + ".em.npz")
    assert not os.path.exists(ckpt + ".boot.npz")


def test_pipeline_em_snapshot_lifecycle(tmp_path, world):
    """A leftover EM snapshot warm-starts the quantifier without changing
    its answer beyond the EM tolerance; a completed run deletes its stage
    snapshots; a snapshot of another shape is ignored; a converged pin
    skips EM exactly."""
    index, reads, _ = world
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    ckpt = str(tmp_path / "run.ckpt.npz")
    cfg = port_config(_cpu_pipeline(bootstrap_samples=4))
    q = Quantifier(port_index(index), cfg, device="cpu")
    fresh = q.quantify_files([fq], checkpoint_path=ckpt)
    assert not os.path.exists(ckpt + ".em.npz")
    assert not os.path.exists(ckpt + ".boot.npz")

    tckpt.save_em_snapshot(ckpt + ".em.npz", fresh.est_counts, 64)
    resumed = q.quantify_files([fq], checkpoint_path=ckpt)
    np.testing.assert_allclose(resumed.est_counts, fresh.est_counts,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(resumed.bootstrap_counts,
                                  fresh.bootstrap_counts)
    assert not os.path.exists(ckpt + ".em.npz")

    tckpt.save_em_snapshot(ckpt + ".em.npz", np.ones(3), 7)
    again = q.quantify_files([fq], checkpoint_path=ckpt)
    np.testing.assert_array_equal(again.est_counts, fresh.est_counts)

    tckpt.save_em_snapshot(ckpt + ".em.npz", fresh.est_counts,
                           fresh.em_iterations, converged=True)
    skipped = q.quantify_files([fq], checkpoint_path=ckpt)
    np.testing.assert_array_equal(skipped.est_counts, fresh.est_counts)
    assert skipped.em_iterations == fresh.em_iterations


def test_capped_em_pins_unconverged(tmp_path, world, monkeypatch):
    """A stage capped by max_iters pins converged=False (a resume goes on
    iterating); a converged stage pins converged=True. Seen by crashing
    the run in the bootstrap, which leaves the pin on disk."""
    index, reads, _ = world
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    ckpt = str(tmp_path / "cap.ckpt.npz")

    def boom(*a, **k):
        raise RuntimeError("simulated crash during bootstrap")

    monkeypatch.setattr(tbootstrap, "run_bootstrap", boom)

    def run(max_iters):
        cfg = port_config(_cpu_pipeline(max_iters=max_iters,
                                        bootstrap_samples=2))
        with pytest.raises(RuntimeError, match="simulated crash"):
            Quantifier(port_index(index), cfg, device="cpu").quantify_files(
                [fq], checkpoint_path=ckpt)
        pin = tckpt.load_em_snapshot(ckpt + ".em.npz")
        assert pin is not None
        os.remove(ckpt + ".em.npz")
        return pin

    _, it_capped, conv_capped = run(max_iters=8)
    assert conv_capped is False and it_capped >= 8
    _, _, conv_ok = run(max_iters=5000)
    assert conv_ok is True


def test_bootstrap_snapshot_resumes_the_stage(tmp_path, world, monkeypatch):
    """A bootstrap snapshot left by a crash warm-starts the bootstrap
    stage: the resumed run's replicates equal the uninterrupted ones."""
    index, reads, _ = world
    fq = str(tmp_path / "reads.fq")
    _write_fastq(fq, reads)
    ckpt = str(tmp_path / "boot.ckpt.npz")
    cfg = port_config(_cpu_pipeline(bootstrap_samples=4, backend="csr",
                                    check_every=8))
    q = Quantifier(port_index(index), cfg, device="cpu")
    fresh = q.quantify_files([fq], checkpoint_path=ckpt)
    monkeypatch.setattr(tckpt, "SNAPSHOT_MIN_INTERVAL_S", 0.0)
    monkeypatch.setattr("seekmer_tpu_torch.em.em.SYNC_TARGET_S", 0.0)
    real = tbootstrap.batched_em

    def crash_after_a_snapshot(*a, on_sync=None, **k):
        def sync(alpha, it):
            on_sync(alpha, it)
            raise Boom
        return real(*a, on_sync=sync, **k)

    monkeypatch.setattr(tbootstrap, "batched_em", crash_after_a_snapshot)
    with pytest.raises(Boom):
        q.quantify_files([fq], checkpoint_path=ckpt)
    snap = tckpt.load_em_snapshot(ckpt + ".boot.npz")
    assert snap is not None and snap[0].shape == (index.num_transcripts, 4)
    monkeypatch.setattr(tbootstrap, "batched_em", real)
    resumed = q.quantify_files([fq], checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed.bootstrap_counts,
                                  fresh.bootstrap_counts)
    assert not os.path.exists(ckpt + ".boot.npz")


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_batch_reads_match_jax(world, paired):
    """In-memory batching: the JAX batchers' batches, mixed lengths."""
    _, reads, pairs = world
    rng = np.random.default_rng(7)
    r1 = [r[: int(rng.integers(30, 101))] for r in reads[:300]]
    cfg = MapConfig(batch_size=64)
    if paired:
        r2 = [m.encode() for m in pairs.reads2[:300]]
        want = list(jfastq.batch_read_pairs(zip(r1, r2), cfg))
        got = list(tfastq.batch_read_pairs(zip(r1, r2), port_config(cfg)))
    else:
        want = list(jfastq.batch_reads(r1, cfg))
        got = list(tfastq.batch_reads(r1, port_config(cfg)))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for f in ("codes", "lengths", "weights", "codes2", "lengths2"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_quantify_reads_matches_jax(world, paired):
    """Quantifier.quantify_reads: JAX's QuantResult, mapping exactly and
    est_counts within the pipeline bound."""
    index, reads, pairs = world
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12, paired_end=paired),
        em=EMConfig(rel_tol=1e-6, estimate_fld=False))
    r1 = pairs.reads1 if paired else [r.decode() for r in reads]
    mates = pairs.reads2 if paired else None
    want = JQuantifier(index, cfg).quantify_reads(r1, mates)
    got = Quantifier(port_index(index), port_config(cfg),
                     device="cpu").quantify_reads(r1, mates)
    assert (got.total_reads, got.mapped, got.unmapped) == (
        want.total_reads, want.mapped, want.unmapped)
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=RTOL,
                               atol=ATOL)
    assert got.em_iterations == want.em_iterations
