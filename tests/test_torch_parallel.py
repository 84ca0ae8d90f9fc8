"""The port's multi-GPU layer on the CPU: ranks spawned by
``parallel/comm.launch`` over gloo (2 ranks, one test at 4), each under a
hard deadline, against the port's one-rank paths and the JAX package's
``parallel/`` on the conftest's 8 fake devices.

- ``DataParallelMapper`` (dense, fast s = 4, strided s = 4, paired): the
  merged MapResult equal to the one-rank ``Mapper``'s and, as signature
  counts, to JAX ``DataParallelMapper``'s; the FLD histograms summed over
  ranks equal to one rank's (fault 5);
- EM on several ranks (the quantifier runs the one-card ``run_em`` on
  every rank's merged table): the one-rank ``run_em``'s bits and
  iteration count in float32, float64 and SQUAREM, and JAX
  ``run_em_collective`` within its own test's bound;
- the sharded bootstrap: each rank's replicates equal to ``batched_em`` on
  the gathered count matrix, the replicate masses, the resampler's
  moments, the same matrix from the same seed and ranks; one rank's
  snapshots;
- ``infer --device cpu --data-shards 2`` and ``--distributed`` writing the
  one-rank run's ``abundance.tsv``; a failed rank, a skipped collective and
  too few cards all end in an error, never a hang.
"""

import json
import os

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig as JEMConfig
from seekmer_tpu.config import MapConfig as JMapConfig
from seekmer_tpu.config import ShardConfig as JShardConfig
from seekmer_tpu.em.em import build_ec_table as jbuild_ec_table
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import batch_read_pairs as jbatch_read_pairs
from seekmer_tpu.io.fastq import batch_reads as jbatch_reads
from seekmer_tpu.parallel.collective_em import run_em_collective as jcollective
from seekmer_tpu.parallel.data_parallel import DataParallelMapper as JDPMapper
from seekmer_tpu.parallel.mesh import make_mesh
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fasta, write_fastq)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu_torch.em import em as tem
from seekmer_tpu_torch.em.bootstrap import batched_em
from seekmer_tpu_torch.em.em import build_ec_table, run_em
from seekmer_tpu_torch.io.fastq import batch_read_pairs, batch_reads
from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
from seekmer_tpu_torch.map.fld import FLDEstimator
from seekmer_tpu_torch.map.signature import SIG_PAD
from seekmer_tpu_torch.parallel import comm
from seekmer_tpu_torch.parallel.bootstrap_shard import (
    rank_resample, rank_seed, run_bootstrap_sharded)
from tests import torch_parallel_workers as workers
from tests.test_torch_self_contained import port_index

torch.set_num_threads(1)

DEADLINE_S = 240  # a launch that takes longer has hung: killed, failed
B_PAIR = 128  # pairs a batch: the paired input makes 5 batches


@pytest.fixture(scope="module")
def world():
    """tests/test_parallel.py's world (50 transcripts, 1,500 single-end
    reads) and 600 read pairs."""
    rng = np.random.default_rng(321)
    names, seqs = random_transcriptome(
        rng, num_transcripts=50, min_len=200, max_len=1000,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=1500, read_len=100,
                         error_rate=0.005)
    pairs = simulate_reads(rng, seqs, num_reads=600, read_len=100,
                           paired=True, mean_frag=200.0, sd_frag=20.0,
                           error_rate=0.005)
    return (names, seqs, index, [r.encode() for r in sim.reads1],
            [r.encode() for r in pairs.reads1],
            [r.encode() for r in pairs.reads2])


MAP_CASES = {
    "dense": dict(batch_size=256, sig_table_bits=12),
    "fast_s4": dict(batch_size=256, sig_table_bits=12, probe_sample=4,
                    sample_fallback_frac=1.0),
    "strided_s4": dict(batch_size=256, sig_table_bits=12, probe_stride=4),
    "paired": dict(batch_size=B_PAIR, sig_table_bits=12, paired_end=True),
}
EM_CASES = {
    "em_f32": dict(rel_tol=1e-6),
    "em_f64": dict(rel_tol=1e-8, use_x64=True),
    "em_squarem": dict(rel_tol=1e-6, accel="squarem"),
}


def _em_pipelines(names=tuple(EM_CASES)):
    """[(name, PipelineConfig)]: the dense map case and each EM case."""
    return [(n, PipelineConfig().replace(map=MapConfig(**MAP_CASES["dense"]),
                                         em=EMConfig(**EM_CASES[n])))
            for n in names]


def _ec_inputs(index, reads):
    """The one-rank port's resolved ECs of the single-end reads."""
    cfg = MapConfig(**MAP_CASES["dense"])
    res = Mapper(port_index(index), cfg, device="cpu").run(
        batch_reads(reads, cfg))
    members, counts, _ = resolve_signatures(res, port_index(index))
    return members, counts


@pytest.fixture(scope="module")
def ranks2(world):
    """One launch of 2 ranks: every map mode, the EM cases and the B 4
    bootstrap (twice); returns (ranks' outputs, EC inputs)."""
    _, _, index, reads, r1, r2 = world
    members, counts = _ec_inputs(index, reads)
    cases = [(n, MapConfig(**kw), kw.get("paired_end", False))
             for n, kw in MAP_CASES.items()]
    boot = EMConfig(bootstrap_samples=4, bootstrap_seed=7, rel_tol=1e-5)
    outs = comm.launch(2, workers.suite_both, (
        port_index(index), reads, r1, r2, cases, _em_pipelines(),
        (members, counts, boot)), timeout_s=DEADLINE_S)
    return outs, (members, counts), boot


def _one_rank_map(index, reads, mates, cfg):
    """The one-rank Mapper's result and its FLD histogram (paired)."""
    m = Mapper(port_index(index), cfg, device="cpu")
    est = (FLDEstimator(port_index(index), m.device_index)
           if mates is not None else None)
    batches = (batch_read_pairs(zip(reads, mates), cfg) if mates is not None
               else batch_reads(reads, cfg))
    for b in batches:
        if est is not None and est.active:
            est.feed(b)
        m.feed(b)
    return m.finalize(), None if est is None else est.hist.numpy()


def _as_dict(res):
    return {tuple(r[r != int(SIG_PAD)].tolist()): int(n)
            for r, n in zip(res.sigs, res.sig_counts)}


def _same_result(a, b):
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.total_reads, a.mapped, a.overflow, a.collisions) == (
        b.total_reads, b.mapped, b.overflow, b.collisions)


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_data_parallel_matches_one_rank_and_jax(world, ranks2, case):
    """Both ranks hold the merged MapResult of the one-rank Mapper, every
    read mapped once; as signature counts it equals JAX
    DataParallelMapper's over 8 fake devices."""
    _, _, index, reads, r1, r2 = world
    outs = ranks2[0]
    kw = MAP_CASES[case]
    paired = kw.get("paired_end", False)
    src, mates = (r1, r2) if paired else (reads, None)
    want, _ = _one_rank_map(index, src, mates, MapConfig(**kw))
    for out in outs:
        _same_result(out[case][0], want)
    assert want.total_reads == len(src) and 0 < want.mapped <= len(src)
    jcfg = JMapConfig(**kw)
    jdp = JDPMapper(index, jcfg, JShardConfig(data_axis=8))
    jres = jdp.run(jbatch_read_pairs(zip(src, mates), jcfg) if paired
                   else jbatch_reads(src, jcfg))
    assert _as_dict(jres) == _as_dict(want)
    assert jres.total_reads == want.total_reads


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_one_finalize_on_ranks(world, ranks2, case):
    """The ranks finalize through the one-card ``Mapper.finalize``: its
    gather step gives every rank the one-card MapResult, the complex-read
    counter and the EC CSR included, inside the rank's spans
    ``finalize``, ``readback`` and ``merge``."""
    _, _, index, reads, r1, r2 = world
    kw = MAP_CASES[case]
    src, mates = (r1, r2) if kw.get("paired_end", False) else (reads, None)
    want, _ = _one_rank_map(index, src, mates, MapConfig(**kw))
    for out in ranks2[0]:
        got, t = out[case][0], out["spans"][case]
        _same_result(got, want)
        assert got.complex_reads == want.complex_reads
        assert (got.complex_reads is None) == (case == "fast_s4")
        for a, b in zip(got.ec_csr, want.ec_csr):
            assert torch.equal(a, b)
        assert t["readback"] + t["merge"] <= t["finalize"]


def test_fld_histogram_summed_over_ranks(world, ranks2):
    """Fault 5: each rank samples its batches among global batches 0-3
    (batches 0 and 2 on rank 0, 1 and 3 on rank 1), and the histograms
    summed over the ranks equal the one-rank estimator's exactly."""
    _, _, index, _, r1, r2 = world
    outs = ranks2[0]
    _, want = _one_rank_map(index, r1, r2, MapConfig(**MAP_CASES["paired"]))
    (_, h0, s0), (_, h1, s1) = outs[0]["paired"], outs[1]["paired"]
    assert h0.sum() > 0 and h1.sum() > 0 and not np.array_equal(h0, h1)
    np.testing.assert_array_equal(s0, want)
    np.testing.assert_array_equal(s1, want)
    np.testing.assert_array_equal(h0 + h1, want)


@pytest.mark.parametrize("case", list(EM_CASES))
def test_ranks_em_bit_equal_to_run_em(world, ranks2, case):
    """The 2-rank quantifier's est_counts on both ranks have the bits and
    iteration count of the one-rank run_em on the same ECs."""
    _, _, index, _, _, _ = world
    outs, (members, counts), _ = ranks2
    cfg = EMConfig(**EM_CASES[case])
    dtype = torch.float64 if cfg.use_x64 else torch.float32
    ec = build_ec_table(members, counts, index.num_transcripts, dtype=dtype,
                        device="cpu")
    alpha, it = run_em(ec, index.lengths, cfg)
    for out in outs:
        got, got_it = out[case]
        assert got_it == it and got.dtype == alpha.numpy().dtype
        np.testing.assert_array_equal(got, alpha.numpy())


def test_ranks_em_within_jax_bound(world, ranks2):
    """Against JAX run_em_collective on 8 fake devices: the bound of
    tests/test_parallel.py's own single-against-collective check."""
    _, _, index, _, _, _ = world
    outs, (members, counts), _ = ranks2
    jec = jbuild_ec_table(members, counts, index.num_transcripts)
    mesh = make_mesh(JShardConfig(data_axis=8))
    ja, jit = jcollective(jec, index.lengths, JEMConfig(rel_tol=1e-6), mesh)
    got, it = outs[0]["em_f32"]
    np.testing.assert_allclose(got, np.asarray(ja), rtol=1e-4, atol=1e-3)
    assert abs(int(jit) - it) <= 2


def test_rank_seed_distinct_and_bounded():
    """Rank seeds never collide across seeds and ranks in range, and a
    rank outside 0..65535 is refused."""
    seeds = {rank_seed(s, r) for s in range(3) for r in (0, 1, 65535)}
    assert len(seeds) == 9 and rank_seed(2, 5) == 2 * 65536 + 5
    for bad in (-1, 65536):
        with pytest.raises(ValueError, match="out of range"):
            rank_seed(0, bad)


def test_sharded_bootstrap_bits_and_masses(world, ranks2):
    """Each rank's replicates equal batched_em on the gathered (B, E) count
    matrix, bit for bit and iteration for iteration; each replicate keeps
    the mapped mass; a second run gives the same matrix."""
    _, _, index, _, _, _ = world
    outs, (members, counts), boot = ranks2
    ec = build_ec_table(members, counts, index.num_transcripts, device="cpu")
    cmat = torch.cat([rank_resample(ec, boot, r, 2) for r in range(2)])
    want, it = batched_em(cmat, ec.ec_ids, ec.txp_ids, index.lengths,
                          ec.num_ecs, ec.num_transcripts, boot)
    for out in outs:
        (b1, it1), (b2, it2) = out["boot"]
        assert it1 == it2 == it
        np.testing.assert_array_equal(b1, want.numpy())
        np.testing.assert_array_equal(b2, b1)
    np.testing.assert_allclose(want.numpy().sum(axis=1),
                               cmat.sum(dim=1).numpy(), rtol=1e-4)
    assert not torch.equal(cmat[0], cmat[2])  # the ranks draw apart


def test_sharded_bootstrap_one_rank_snapshots(world, monkeypatch):
    """Outside a group (one rank): batched_em's bits and iterations on
    rank 0's resample, and with snapshots due every block, on_sync gets
    the (T, B) iterate at each block end but the last."""
    _, _, index, reads, _, _ = world
    members, counts = _ec_inputs(index, reads)
    ec = build_ec_table(members, counts, index.num_transcripts, device="cpu")
    cfg = EMConfig(bootstrap_samples=3, bootstrap_seed=2, rel_tol=1e-5)
    monkeypatch.setattr(tem, "SYNC_TARGET_S", 0.0)
    snaps = []
    got, it = run_bootstrap_sharded(
        ec, index.lengths, cfg,
        on_sync=lambda a, i: snaps.append((a.shape, i)))
    cmat = rank_resample(ec, cfg, 0, 1)
    want, want_it = batched_em(cmat, ec.ec_ids, ec.txp_ids, index.lengths,
                               ec.num_ecs, ec.num_transcripts, cfg)
    assert it == want_it
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    C = cfg.check_every
    assert snaps == [((index.num_transcripts, 3), C * (k + 1))
                     for k in range(it // C - 1)]


def test_rank_resample_moments_and_seed(world):
    """Each rank's resample is Mult(N, n / N): the mean and variance of
    4 x 64 replicates within 5 standard errors; the same seed and rank
    give the same matrix, another rank another."""
    _, _, index, reads, _, _ = world
    members, counts = _ec_inputs(index, reads)
    ec = build_ec_table(members, counts, index.num_transcripts, device="cpu")
    cfg = EMConfig(bootstrap_samples=256, bootstrap_seed=3)
    mats = [rank_resample(ec, cfg, r, 4).double() for r in range(4)]
    assert torch.equal(mats[1], rank_resample(ec, cfg, 1, 4).double())
    assert not torch.equal(mats[0], mats[1])
    cm = torch.cat(mats)
    n = ec.counts.double()
    N = n.sum()
    p = n / N
    mean_se = torch.sqrt(N * p * (1 - p) / cm.shape[0])
    assert bool((torch.abs(cm.mean(0) - n) <= 5 * mean_se + 1e-9).all())
    var = N * p * (1 - p)
    big = var > 20
    rel = torch.abs(cm.var(0)[big] / var[big] - 1)
    assert bool((rel < 5 * np.sqrt(2 / cm.shape[0]) + 0.05).all())
    np.testing.assert_array_equal(cm.sum(1).numpy(), np.full(256, float(N)))


def test_four_ranks(world):
    """Four ranks: the dense map and the quantifier's float32 EM as one
    rank."""
    _, _, index, reads, _, _ = world
    members, counts = _ec_inputs(index, reads)
    cfg = MapConfig(**MAP_CASES["dense"])
    outs = comm.launch(4, workers.suite, (
        port_index(index), reads, None, [("dense", cfg, False)],
        _em_pipelines(("em_f32",)), None), timeout_s=DEADLINE_S)
    want, _ = _one_rank_map(index, reads, None, cfg)
    ec = build_ec_table(members, counts, index.num_transcripts, device="cpu")
    alpha, it = run_em(ec, index.lengths, EMConfig(**EM_CASES["em_f32"]))
    for out in outs:
        assert out["world"] == 4
        _same_result(out["dense"][0], want)
        np.testing.assert_array_equal(out["em_f32"][0], alpha.numpy())
        assert out["em_f32"][1] == it


# ---- the CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def files(world, tmp_path_factory):
    names, seqs, index, reads, r1, r2 = world
    tmp = tmp_path_factory.mktemp("torch_parallel")
    paths = {"idx": str(tmp / "index.npz"), "r1": str(tmp / "r1.fq"),
             "r2": str(tmp / "r2.fq"), "se": str(tmp / "se.fq"),
             "se_a": str(tmp / "se_a.fq"), "se_b": str(tmp / "se_b.fq")}
    index.save(paths["idx"])
    text = [r.decode() for r in reads]
    write_fastq(paths["r1"], [r.decode() for r in r1])
    write_fastq(paths["r2"], [r.decode() for r in r2])
    write_fastq(paths["se"], text)
    write_fastq(paths["se_a"], text[:700])
    write_fastq(paths["se_b"], text[700:])
    write_fasta(str(tmp / "ref.fa"), names, seqs)
    return tmp, paths


def _argv(tmp, p, out, inputs, *opts):
    """``infer``'s arguments on the CPU, 128 reads a batch."""
    return ["infer", p["idx"], str(tmp / out), *inputs, "--device", "cpu",
            "--batch-size", str(B_PAIR), "--sig-table-bits", "12", *opts]


def test_cli_data_shards_matches_one_rank(files):
    """infer --data-shards 2 on the CPU (paired, FLD estimated, 2
    bootstrap replicates) writes the one-rank run's abundance.tsv byte for
    byte; run_info.json holds the ranks and their summed launches."""
    tmp, p = files
    reads = ([p["r1"]], "--mates", p["r2"], "--bootstrap", "2")
    assert cli.main(_argv(tmp, p, "one", *reads)) == 0
    assert cli.main(_argv(tmp, p, "two", *reads, "--data-shards", "2")) == 0
    one = (tmp / "one" / "abundance.tsv").read_bytes()
    assert (tmp / "two" / "abundance.tsv").read_bytes() == one
    a = json.load(open(tmp / "one" / "run_info.json"))
    b = json.load(open(tmp / "two" / "run_info.json"))
    assert (a["world_size"], b["world_size"]) == (1, 2)
    for key in ("total_reads", "mapped", "em_iterations", "fld",
                "log_likelihood"):
        assert a[key] == b[key], key
    assert b["kernel_launches"] == dict.fromkeys(a["kernel_launches"], 0)
    boot = np.load(tmp / "two" / "bootstrap.npz")["est_counts"]
    np.testing.assert_allclose(boot.sum(axis=1), b["mapped"], rtol=1e-4)


@pytest.mark.parametrize("hosts", [2, 1])
def test_cli_distributed(files, hosts):
    """infer --distributed in a 2-rank group writes the one-rank run's
    abundance.tsv on the whole single-end input (every read mapped once;
    EM over the merged counts): as two hosts, each given half of the
    input, and as one host of two ranks (torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE), both given all of it and dealing its batches."""
    tmp, p = files
    whole = tmp / "whole" / "abundance.tsv"
    if not whole.exists():
        assert cli.main(_argv(tmp, p, "whole", [p["se"]])) == 0
    out = f"dist{hosts}"
    if hosts == 2:
        inputs, envs = [[p["se_a"]], [p["se_b"]]], None
    else:
        inputs = [[p["se"]]] * 2
        envs = [{"LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"}
                for r in range(2)]
    argvs = [_argv(tmp, p, out, i, "--distributed") for i in inputs]
    outs = comm.launch(2, workers.cli_infer, (argvs, envs),
                       timeout_s=DEADLINE_S)
    assert outs == [0, 0]
    assert (tmp / out / "abundance.tsv").read_bytes() == whole.read_bytes()
    info = json.load(open(tmp / out / "run_info.json"))
    assert info["world_size"] == 2 and info["total_reads"] == 1500



def test_too_few_cards_refused(files, monkeypatch):
    """--data-shards 2 on the card asks for two cards: with none, or one,
    the run is refused before any rank starts; never the CPU instead."""
    tmp, p = files
    argv = _argv(tmp, p, "x", [p["se"]], "--data-shards", "2")
    argv[argv.index("cpu")] = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.main(argv)
    assert not os.path.exists(tmp / "x")


def test_launch_refuses_nccl_on_a_shared_card():
    """Two ranks on one card take gloo only when asked: NCCL, the default
    on cards, refuses them before any rank starts."""
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        comm.launch(2, workers.fail_on_rank1, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="both the CPU and cards"):
        comm.launch(2, workers.fail_on_rank1, devices=["cpu", "cuda:0"])


def test_failed_rank_fails_the_launch():
    """A rank that raises ends the launch with its error; the rank that
    waits in a barrier is killed, not left behind."""
    with pytest.raises(comm.RankFailed, match="fails on purpose"):
        comm.launch(2, workers.fail_on_rank1, timeout_s=DEADLINE_S)


def test_skipped_collective_times_out():
    """A rank that skips a collective makes the other's raise within the
    group's timeout, rather than hang."""
    with pytest.raises(comm.RankFailed, match="rank 0 of 2"):
        comm.launch(2, workers.skip_a_collective, timeout_s=DEADLINE_S,
                    collective_timeout_s=3)
