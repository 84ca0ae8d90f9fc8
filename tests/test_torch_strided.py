"""Strided mode in the port: the plain ``lookup_ecs_strided`` against the
JAX function, the dense invariants, a numpy model of K7's tiles and queue
against the plain version, the port's ``Mapper`` with ``probe_stride``
against the JAX ``Mapper`` (single-end and paired, each mate its own
segment), the index's run-length aux column, and ``infer --probe-stride``.
Every stage is integer work: every comparison is exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu import encoding as jenc
from seekmer_tpu.config import IndexConfig as JIndexConfig
from seekmer_tpu.config import MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import ReadBatch as JReadBatch
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.ops.kmer_pack import pack_canonical as j_pack
from seekmer_tpu.ops.probe import device_table_layout as j_layout
from seekmer_tpu.ops.probe import lookup_ecs_strided as j_strided
from seekmer_tpu.utils.simulate import (
    isoform_transcriptome,
    random_transcriptome,
    simulate_packed_pairs,
    simulate_reads,
    write_fastq,
)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.index import build as tbuild
from seekmer_tpu_torch.io.fastq import ReadBatch
from seekmer_tpu_torch.map.driver import DeviceIndex, Mapper
from seekmer_tpu_torch.ops import probe, strided_cuda
from tests.test_torch_fast import _batches, _same_result
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    """tests/test_strided.py's world: 40 transcripts sharing prefixes."""
    rng = np.random.default_rng(13)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.6)
    return build_index_from_seqs(names, seqs), names, seqs


def _windows(index, seqs, read_len, error_rate, n=300, seed=5):
    """JAX-packed windows of simulated reads as numpy (hi, lo, valid)."""
    sim = simulate_reads(np.random.default_rng(seed), seqs, num_reads=n,
                         read_len=read_len, error_rate=error_rate)
    codes = np.full((n, read_len), 4, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, r in enumerate(sim.reads1):
        c = jenc.seq_to_codes(r)
        codes[i, :c.size] = c
        lengths[i] = c.size
    return tuple(np.asarray(a) for a in
                 j_pack(jnp.asarray(codes), jnp.asarray(lengths), index.k))


def _jax_geo(index):
    return (jnp.asarray(j_layout(index.table, index.bucket)),
            index.main_slots,
            jnp.asarray(j_layout(index.stash, index.bucket)),
            index.stash_slots, index.bucket)


def _geo(index):
    di = DeviceIndex.from_host(port_index(index), "cpu")
    return di.table, di.main_slots, di.stash, di.stash_slots, di.bucket


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# read lengths 100 and 97 give P = 76 and 73 windows at k = 25: P - 1 = 75
# is a multiple of no stride here, P - 1 = 72 of 2, 4 and 8 (the extra
# sample then repeats the last regular one)
@pytest.mark.parametrize("read_len", [100, 97])
@pytest.mark.parametrize("error_rate", [0.0, 0.02])
@pytest.mark.parametrize("stride", [2, 4, 8, 16])
def test_lookup_strided_matches_jax(world, stride, error_rate, read_len):
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, read_len, error_rate)
    want = np.asarray(j_strided(*(jnp.asarray(a) for a in (hi, lo, valid)),
                                *_jax_geo(index), stride))
    got = probe.lookup_ecs_strided(*_t(hi, lo, valid), *_geo(index), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if error_rate:  # some windows were looked up as needy, some filled
        assert (want[valid] >= 0).mean() < 1.0


@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("error_rate", [0.0, 0.02])
def test_strided_vs_dense_invariants(world, stride, error_rate):
    """tests/test_strided.py's invariants on the port: error-free, equal to
    dense; with errors, every dense hit equal, and divergences only fills
    over dense misses with an EC of the same read's dense hits."""
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, 100, error_rate)
    geo = _geo(index)
    dense = probe.lookup_ecs(*_t(hi, lo, valid), *geo).numpy()
    strided = probe.lookup_ecs_strided(*_t(hi, lo, valid), *geo,
                                       stride).numpy()
    v = valid
    if error_rate == 0.0:
        np.testing.assert_array_equal(strided[v], dense[v])
    hit = v & (dense >= 0)
    np.testing.assert_array_equal(strided[hit], dense[hit])
    div = v & (strided != dense)
    assert (dense[div] == -1).all() and (strided[div] >= 0).all()
    for b in np.unique(np.nonzero(div)[0]):
        read_ecs = set(dense[b][v[b] & (dense[b] >= 0)].tolist())
        assert set(strided[b][div[b]].tolist()) <= read_ecs
    assert (strided[~v] == -1).all()


def _k7_model(hi, lo, valid, geo, P, s):
    """K7 (csrc/strided.cu) step by step in numpy on flat segments of P
    windows: its plan's tiles, the sampled lanes 32 at a time into a queue
    of keys, lookup rounds of the queue's first 32, a slot a sample, then
    each 32 windows of a segment filled from the slots or queued, and the
    tile's last partial round. A key's 3-state result is its ecaux (ec <<
    AUX_BITS | d) when found, else -1."""
    S, segs = strided_cuda.strided_plan(P, s)
    n_seg = hi.size // P
    out = np.full(hi.size, 999_999, np.int64)

    def lookup(keys):
        h, l_ = (torch.tensor([k[i] for k in keys], dtype=torch.int32)
                 for i in (0, 1))
        ec, aux = probe.lookup_ecs_aux(h, l_, torch.ones_like(h, dtype=bool),
                                       *geo)
        return np.where(ec.numpy() >= 0,
                        (ec.numpy() << probe.AUX_BITS) | aux.numpy(), -1)

    def ec_of(m):
        return m >> probe.AUX_BITS if m >= 0 else -1

    for seg0 in range(0, n_seg, segs):
        T = min(segs, n_seg - seg0)
        base = seg0 * P
        slot = np.full(T * S, -7, np.int64)
        queue = []

        def flush(sample):
            batch = queue[:32]
            del queue[:32]
            for (_, _, tag), m in zip(batch, lookup(batch)):
                if sample:
                    slot[tag] = m
                else:
                    out[base + tag] = ec_of(m)

        for q0 in range(0, T * S, 32):
            for i in range(q0, min(q0 + 32, T * S)):
                t = i // S
                x = base + t * P + min((i - t * S) * s, P - 1)
                slot[i] = -1
                if valid[x]:
                    queue.append((hi[x], lo[x], i))
            if len(queue) >= 32:
                flush(True)
        if queue:
            flush(True)
        assert (slot != -7).all()
        for t in range(T):
            sl = slot[t * S:(t + 1) * S]
            for c0 in range(0, P, 32):
                for col in range(c0, min(c0 + 32, P)):
                    x = t * P + col
                    v = bool(valid[base + x])
                    gap = col // s
                    pl, ml = gap * s, sl[gap]
                    need = False
                    if col == P - 1:
                        val = ec_of(sl[S - 1])
                    elif col == pl:
                        val = ec_of(ml)
                    else:
                        mr, pr = sl[gap + 1], min(pl + s, P - 1)
                        cov_l = ml >= 0 and (ml & probe.AUX_MASK) >= col - pl
                        cov_r = mr >= 0 and (mr & probe.AUX_MASK) >= pr - col
                        val = (ml >> probe.AUX_BITS if cov_l else
                               mr >> probe.AUX_BITS if cov_r else -1)
                        need = v and not cov_l and not cov_r
                    if need:
                        queue.append((hi[base + x], lo[base + x], x))
                    else:
                        out[base + x] = val if v else -1
                if len(queue) >= 32:
                    flush(False)
        if queue:
            flush(False)
    return out


@pytest.mark.parametrize("read_len,stride,segments", [
    (100, 2, 1), (100, 16, 2), (97, 8, 2), (97, 3, 1), (26, 2, 2)],
    ids=["P76_s2_single", "P76_s16_paired", "P73_s8_paired", "P73_s3",
         "P2_s2_paired"])
def test_k7_model_matches_plain(world, read_len, stride, segments):
    """The numpy model of K7 equals the plain version (each segment on its
    own) on reads with errors, N runs and all-invalid rows; the tiles hold
    several segments, so the queue carries keys across segments."""
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, read_len, 0.02, n=70)
    valid = valid.copy()
    valid[3] = False  # an all-invalid row
    valid[5, 10:40] = False  # a run of N bases
    B, P = hi.shape
    if segments == 2:  # pair rows up: row b's mates are reads 2b, 2b + 1
        hi, lo, valid = (a.reshape(B // 2, 2 * P) for a in (hi, lo, valid))
    geo = _geo(index)
    want = strided_cuda.lookup_ecs_strided(*_t(hi, lo, valid), *geo, stride,
                                           segments=segments).numpy()
    got = _k7_model(hi.ravel(), lo.ravel(), valid.ravel(), geo, P, stride)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert strided_cuda.strided_plan(P, stride).segs > 1


def test_strided_plan():
    """Every plan fits the kernel's slots: S = ceil(P / s) + 1 sampled
    columns, segs * S <= 520, 1 <= segs <= 32, up to P = 1,024."""
    for P in (1, 2, 31, 73, 76, 104, 488, 1024):
        for s in (2, 3, 4, 8, 16, 64):
            S, segs = strided_cuda.strided_plan(P, s)
            assert S == len(probe.strided_columns(P, s))
            assert 1 <= segs <= 32 and segs * S <= strided_cuda.MAX_SLOTS


@pytest.mark.parametrize("stride", [2, 8])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_mapper_strided_matches_jax(paired, stride):
    """MapResult of the port's Mapper with probe_stride equal to the JAX
    Mapper's: signatures, counts, total, mapped, overflow, collisions."""
    rng = np.random.default_rng(43)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=700,
        shared_prefix_frac=0.6)
    sim = simulate_reads(rng, seqs, num_reads=300, read_len=90, paired=True,
                         mean_frag=180.0, error_rate=0.01)
    junk = ["".join(rng.choice(list("ACGTN"), size=90)) for _ in range(20)]
    index = build_index_from_seqs(names, seqs)
    cfg = MapConfig(batch_size=128, sig_table_bits=10, paired_end=paired,
                    probe_stride=stride, collision_audit_every=2)
    r1 = sim.reads1 + junk
    r2 = (sim.reads2 + junk[::-1]) if paired else None
    want = JMapper(index, cfg).run(_batches(r1, r2, cfg))
    got = Mapper(port_index(index), port_config(cfg), device="cpu").run(
        _batches(r1, r2, cfg))
    _same_result(got, want)
    assert got.total_reads == len(r1) and 0 < got.mapped < len(r1)


def test_paired_strided_map_step_matches_jax():
    """Paired strided mapping probes each mate as its own segment: with
    errors its MapResult equals the JAX Mapper's (which looks up each mate
    separately), and on error-free mates it equals dense mapping
    (tests/test_map_device.py ``test_paired_strided_matches_dense``)."""
    rng = np.random.default_rng(7)
    names, seqs, genes = isoform_transcriptome(rng, num_genes=12)
    index = build_index_from_seqs(names, seqs, genes=genes)
    L = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    sigs = {}
    for err in (0.0, 0.02):
        c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, 128, read_len=96,
                                          error_rate=err)
        for stride in (1, 3):
            cfg = MapConfig(batch_size=128, paired_end=True,
                            sig_table_bits=12, probe_stride=stride)
            jm = JMapper(index, cfg)
            jm.feed(JReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
            tm = Mapper(port_index(index), port_config(cfg), device="cpu")
            tm.feed(ReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
            got, want = tm.finalize(), jm.finalize()
            _same_result(got, want)
            sigs[err, stride] = {tuple(s.tolist()): int(n)
                                 for s, n in zip(got.sigs, got.sig_counts)}
    assert sigs[0.0, 1] == sigs[0.0, 3]


def test_run_length_aux_column_matches_jax(world):
    """The port's index copy writes the same aux column (the EC run
    lengths strided mode fills from) as the JAX package, from the same
    sequences, and the column is not empty."""
    index, names, seqs = world
    got = tbuild.build_index_from_seqs(names, seqs)
    for name in ("table", "stash"):
        a, b = getattr(got, name), getattr(index, name)
        np.testing.assert_array_equal(a[:, 3], b[:, 3], err_msg=name)
    occ = index.table[:, 0] != -1
    assert (index.table[occ, 3] > 0).mean() > 0.5
    assert port_config(JIndexConfig()).run_length_aux


def test_cli_probe_stride_reaches_the_config(world, tmp_path, monkeypatch):
    """``infer --probe-stride 4`` maps in strided mode: the flag reaches
    MapConfig, run_info.json records it, and the mapped count equals the
    JAX Mapper's strided run on the same reads."""
    from seekmer_tpu_torch.models import quantifier

    index, _, seqs = world
    sim = simulate_reads(np.random.default_rng(9), seqs, num_reads=400,
                         read_len=100, error_rate=0.01)
    fq, idx = str(tmp_path / "r.fq"), str(tmp_path / "index.npz")
    write_fastq(fq, sim.reads1)
    index.save(idx)
    seen = []
    real = quantifier.Quantifier.__init__

    def spy(self, index, cfg, device="cuda"):
        seen.append(cfg.map)
        real(self, index, cfg, device=device)

    monkeypatch.setattr(quantifier.Quantifier, "__init__", spy)
    out = str(tmp_path / "out")
    assert cli.main(["infer", idx, out, fq, "--device", "cpu",
                     "--batch-size", "256", "--probe-stride", "4"]) == 0
    assert seen[0].probe_stride == 4
    info = json.load(open(os.path.join(out, "run_info.json")))
    assert info["probe_stride"] == 4 and info["probe_sample"] == 0
    assert info["kernel_launches"]["strided"] == 0  # CPU: no kernel
    cfg = MapConfig(batch_size=256, probe_stride=4)
    want = JMapper(index, cfg).run(_batches(sim.reads1, None, cfg))
    assert info["total_reads"] == want.total_reads
    assert 0 < info["mapped"] <= want.mapped
