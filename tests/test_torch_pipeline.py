"""The port end to end on the CPU: Quantifier and the CLI against the JAX
Quantifier and the float64 oracle, bootstrap output, ``--checkpoint``,
``--pack-cache`` and ``--trace-dir``, the refusal of features outside the
port, and a run in a process where JAX cannot be imported."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.writer import read_abundance
from seekmer_tpu.models.quantifier import Quantifier as JQuantifier
from seekmer_tpu.utils.simulate import (
    random_transcriptome,
    simulate_reads,
    write_fasta,
    write_fastq,
)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.models.quantifier import Quantifier
from tests.oracle import oracle
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(2024)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=300, max_len=1200,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100,
                         error_rate=0.005)
    pairs = simulate_reads(rng, seqs, num_reads=300, read_len=80,
                           paired=True, mean_frag=220.0, error_rate=0.005)
    files = {n: str(tmp / f"{n}.fq") for n in ("se", "r1", "r2")}
    write_fastq(files["se"], sim.reads1)
    write_fastq(files["r1"], pairs.reads1)
    write_fastq(files["r2"], pairs.reads2)
    fa, idx = str(tmp / "ref.fa"), str(tmp / "index.npz")
    write_fasta(fa, names, seqs)
    index.save(idx)
    return tmp, index, sim, pairs, files, fa, idx


# est_counts of float32 EM against the float64 oracle: the bound the JAX
# package's own pipeline test holds its Quantifier to
RTOL, ATOL = 5e-3, 5e-2


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_quantifier_matches_jax_and_oracle(world, paired):
    _, index, sim, pairs, files, _, _ = world
    map_cfg = MapConfig(batch_size=128, sig_table_bits=12,
                        paired_end=paired)
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000, estimate_fld=False,
                      mean_fragment_length=220.0 if paired else 200.0)
    cfg = PipelineConfig().replace(map=map_cfg, em=em_cfg)
    fq = [files["r1"] if paired else files["se"]]
    mates = [files["r2"]] if paired else None
    want = JQuantifier(index, cfg).quantify_files(fq, mate_paths=mates)
    got = Quantifier(port_index(index), port_config(cfg),
                     device="cpu").quantify_files(
        fq, mate_paths=mates)
    assert (got.total_reads, got.mapped, got.unmapped) == (
        want.total_reads, want.mapped, want.unmapped)
    reads = pairs if paired else sim
    o = oracle.quantify(reads.reads1, index, map_cfg, em_cfg,
                        mates=reads.reads2 if paired else None)
    assert got.unmapped == o["unmapped"]
    np.testing.assert_allclose(got.est_counts, o["est_counts"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=RTOL,
                               atol=ATOL)
    assert got.em_iterations == want.em_iterations


def test_cli_index_and_infer(world):
    tmp, index, sim, _, files, fa, _ = world
    idx, out = str(tmp / "cli_index.npz"), str(tmp / "cli_out")
    assert cli.main(["index", fa, idx]) == 0
    assert cli.main(["infer", idx, out, files["se"], "--device", "cpu",
                     "--batch-size", "256", "--em-tolerance", "1e-6",
                     "--em-max-iters", "2000"]) == 0
    tab = read_abundance(os.path.join(out, "abundance.tsv"))
    assert tab["target_id"].tolist() == index.names.tolist()
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    o = oracle.quantify(sim.reads1, index, MapConfig(), em_cfg)
    np.testing.assert_allclose(tab["est_counts"], o["est_counts"],
                               rtol=RTOL, atol=ATOL)
    info = json.load(open(os.path.join(out, "run_info.json")))
    assert info["total_reads"] == len(sim.reads1)
    assert info["unmapped"] == o["unmapped"]
    assert info["device"] == "cpu"
    assert set(info["kernel_launches"]) == {"pack", "lookup", "signature",
                                            "accumulate", "em", "sample",
                                            "merge", "em_csr", "strided",
                                            "ec_sum", "route", "unroute"}
    assert info["fld"] is None and info["bootstrap_samples"] == 0
    assert info["probe_sample"] == 0 and info["probe_stride"] == 1
    assert not os.path.exists(os.path.join(out, "bootstrap.npz"))


def test_cli_bootstrap_writes_replicates(world):
    """infer --bootstrap 4 writes bootstrap.npz of shape (4, T) whose rows
    each carry the mapped reads, and abundance.h5 with the replicates."""
    tmp, index, _, _, files, _, idx = world
    out = str(tmp / "boot_out")
    assert cli.main(["infer", idx, out, files["se"], "--device", "cpu",
                     "--batch-size", "256", "--bootstrap", "4", "--seed",
                     "3"]) == 0
    info = json.load(open(os.path.join(out, "run_info.json")))
    assert info["bootstrap_samples"] == 4
    assert info["timings"]["bootstrap_s"] > 0
    boot = np.load(os.path.join(out, "bootstrap.npz"))
    assert boot["est_counts"].shape == (4, index.num_transcripts)
    np.testing.assert_array_equal(boot["names"].astype(str), index.names)
    np.testing.assert_allclose(boot["est_counts"].sum(axis=1),
                               info["mapped"], rtol=1e-4)
    h5py = pytest.importorskip("h5py")
    with h5py.File(os.path.join(out, "abundance.h5")) as f:
        assert int(f["aux/num_bootstrap"][0]) == 4
        np.testing.assert_array_equal(f["bootstrap/bs3"][:],
                                      boot["est_counts"][3])


def _paired_infer(world, out, *argv):
    """infer on the paired files, 128 pairs a batch, 2 bootstrap
    replicates; returns (abundance.tsv's text, run_info.json)."""
    tmp, _, _, _, files, _, idx = world
    out = str(tmp / out)
    assert cli.main(["infer", idx, out, files["r1"], "--mates", files["r2"],
                     "--device", "cpu", "--batch-size", "128",
                     "--bootstrap", "2", *argv]) == 0
    info = json.load(open(os.path.join(out, "run_info.json")))
    return open(os.path.join(out, "abundance.tsv")).read(), info


def test_cli_checkpoint(world):
    """infer --checkpoint: the uninterrupted run's output, the map
    checkpoint left with its cursor at the end of the input and the FLD
    estimator's histogram, the stage snapshots deleted; a rerun resumes
    from the finished checkpoint to the same output."""
    tmp = world[0]
    ckpt = str(tmp / "cli.ckpt.npz")
    plain, info0 = _paired_infer(world, "ck_plain")
    got, info = _paired_infer(world, "ck_run", "--checkpoint", ckpt,
                              "--checkpoint-every", "1")
    assert got == plain and info["mapped"] == info0["mapped"]
    from seekmer_tpu_torch.utils.checkpoint import load_map_checkpoint

    _, total, cursor, fld = load_map_checkpoint(ckpt, "cpu")
    assert total == info["total_reads"] and cursor["s1"][0] == 1
    assert fld[1] == 3 and info["fld"]["samples"] == int(fld[0][1:].sum())
    assert not os.path.exists(ckpt + ".em.npz")
    assert not os.path.exists(ckpt + ".boot.npz")
    again, info2 = _paired_infer(world, "ck_again", "--checkpoint", ckpt)
    assert again == plain and info2["total_reads"] == info["total_reads"]


def test_cli_pack_cache(world):
    """infer --pack-cache DIR: the build run and the hit run give the
    uncached run's output; the cache carries its build id."""
    tmp = world[0]
    cache = str(tmp / "cli.smpack")
    plain, _ = _paired_infer(world, "pc_plain")
    built, _ = _paired_infer(world, "pc_build", "--pack-cache", cache)
    meta = json.load(open(os.path.join(cache, "meta.json")))
    assert meta["build_id"] and len(meta["batches"]) == 3
    hit, info = _paired_infer(world, "pc_hit", "--pack-cache", cache)
    assert built == plain and hit == plain
    assert info["total_reads"] == 300


def test_cli_trace_dir(world):
    """infer --trace-dir D: the uncached run's output, and one trace file
    in D holding the run's stage ranges."""
    tmp = world[0]
    trace = str(tmp / "cli_trace")
    plain, _ = _paired_infer(world, "tr_plain")
    got, _ = _paired_infer(world, "tr_run", "--trace-dir", trace)
    assert got == plain
    assert os.listdir(trace) == ["infer.trace.json"]
    names = {e.get("name") for e in json.load(
        open(os.path.join(trace, "infer.trace.json")))["traceEvents"]}
    assert {"infer", "map", "resolve", "em", "bootstrap", "ingest",
            "upload"} <= names


def _infer_parser(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices["infer"]


def test_cli_parses_every_jax_infer_flag():
    """Every option of the JAX CLI's ``infer`` parses in the port's with a
    value of its kind, to the same dest and value."""
    from seekmer_tpu.cli import build_parser as j_build_parser

    port = _infer_parser(cli.build_parser())
    for action in _infer_parser(j_build_parser())._actions:
        if not action.option_strings or action.dest == "help":
            continue
        opt = action.option_strings[-1]
        if action.nargs == 0:
            argv, want = [opt], True
        elif action.choices:
            argv, want = [opt, action.choices[-1]], action.choices[-1]
        elif action.nargs in ("*", "+"):
            argv, want = [opt, "x.fq"], ["x.fq"]
        elif action.nargs == "?":
            argv, want = [opt], action.const
        else:
            kind = action.type or str
            want = kind("3")
            argv = [opt, "3"]
        args = port.parse_args(["index.npz", "out", "r1.fq", *argv])
        assert getattr(args, action.dest) == want, (opt, argv)


def test_cli_flags_reach_the_config(world, monkeypatch):
    """--probe-sample, --sample-fallback and --io-workers reach MapConfig,
    the TPU-only knobs are accepted, and run_info.json records
    probe_sample."""
    from seekmer_tpu_torch.models import quantifier

    tmp, _, _, _, files, _, idx = world
    seen = []
    real = quantifier.Quantifier.__init__

    def spy(self, index, cfg, device="cuda", **kw):
        seen.append(cfg.map)
        real(self, index, cfg, device=device, **kw)

    monkeypatch.setattr(quantifier.Quantifier, "__init__", spy)
    out = str(tmp / "flags_out")
    assert cli.main(["infer", idx, out, files["se"], "--device", "cpu",
                     "--batch-size", "256", "--probe-sample", "8",
                     "--sample-fallback", "0.25", "--io-workers", "1",
                     "--probe-chunks", "2", "--pack-backend", "pallas",
                     "--no-h2d-pack", "--checkpoint-every", "7"]) == 0
    (cfg,) = seen
    assert (cfg.probe_sample, cfg.sample_fallback_frac, cfg.io_workers,
            cfg.probe_chunks, cfg.pack_backend, cfg.h2d_pack_2bit) == (
        8, 0.25, 1, 2, "pallas", False)
    info = json.load(open(os.path.join(out, "run_info.json")))
    assert info["probe_sample"] == 8
    assert 0 < info["mapped"] <= info["total_reads"]
    with pytest.raises(ValueError, match="sample_fallback_frac"):
        cli.main(["infer", idx, out, files["se"], "--device", "cpu",
                  "--probe-sample", "8", "--sample-fallback", "2"])


def test_cuda_requested_without_card_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, index, _, _, files, _, idx = world
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Quantifier(port_index(index), port_config(PipelineConfig()),
                   device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", idx, "out", files["se"]])  # --device cuda


_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of JAX fails
import numpy as np
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.utils.simulate import (
    random_transcriptome, simulate_reads, write_fasta, write_fastq)
work = sys.argv[1]
rng = np.random.default_rng(3)
names, seqs = random_transcriptome(rng, num_transcripts=30, min_len=200,
                                   max_len=600, shared_prefix_frac=0.5)
write_fasta(work + "/ref.fa", names, seqs)
pairs = simulate_reads(rng, seqs, num_reads=600, read_len=80, paired=True,
                       mean_frag=200.0)
write_fastq(work + "/r1.fq", pairs.reads1)
write_fastq(work + "/r2.fq", pairs.reads2)
assert cli.main(["index", work + "/ref.fa", work + "/index.npz"]) == 0
assert cli.main(["infer", work + "/index.npz", work + "/out", work + "/r1.fq",
                 "--mates", work + "/r2.fq", "--bootstrap", "2",
                 "--device", "cpu", "--batch-size", "256",
                 "--sig-table-bits", "10"]) == 0
assert sys.modules["jax"] is None
print("NO_JAX_OK")
"""


def test_runs_with_jax_blocked(tmp_path):
    """The port and the host code it shares never need JAX: index and a
    paired infer, with fragment-length estimation and a bootstrap, run in
    a process where importing JAX fails."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
    info = json.load(open(tmp_path / "out" / "run_info.json"))
    assert info["total_reads"] == 600 and info["mapped"] > 450
    assert info["fld"] is not None and info["bootstrap_samples"] == 2
    boot = np.load(tmp_path / "out" / "bootstrap.npz")["est_counts"]
    assert boot.shape == (2, 30)
