"""The port's fragment-length estimation (``seekmer_tpu_torch.map.fld``)
against the JAX package and the float64 oracle: the histogram exactly, the
estimate through a paired Quantifier, and the CLI's ``run_info["fld"]``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu import cli as jcli
from seekmer_tpu import encoding as enc
from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import ReadBatch
from seekmer_tpu.map import fld as jfld
from seekmer_tpu.map.driver import DeviceIndex as JDeviceIndex
from seekmer_tpu.models.quantifier import Quantifier as JQuantifier
from seekmer_tpu.utils.simulate import (
    random_transcriptome,
    simulate_packed_pairs,
    write_fasta,
    write_fastq,
)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.map import fld
from seekmer_tpu_torch.map.driver import DeviceIndex, Mapper
from seekmer_tpu_torch.models.quantifier import Quantifier
from tests.oracle import oracle as orc

torch.set_num_threads(1)
MEAN, SD, L = 250.0, 25.0, 100


@pytest.fixture(scope="module")
def setup():
    """The world of tests/test_fld.py."""
    rng = np.random.default_rng(7)
    names, seqs = random_transcriptome(
        rng, num_transcripts=60, min_len=600, max_len=3000)
    index = build_index_from_seqs(names, seqs)
    c1, c2, _ = simulate_packed_pairs(
        rng, seqs, num_batches=2, batch_size=2048, read_len=L,
        mean_frag=MEAN, sd_frag=SD, error_rate=0.003)
    return index, names, seqs, c1, c2


def _batches(c1, c2):
    B = c1.shape[1]
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    return [ReadBatch(codes=c1[i], lengths=lengths, weights=w,
                      codes2=c2[i], lengths2=lengths)
            for i in range(c1.shape[0])]


def test_estimator_hist_equals_jax_and_oracle(setup):
    index, _, seqs, c1, c2 = setup
    assert int((index.stash[:, 0] >= 0).sum()) == 0, "fixture grew a stash"
    want = jfld.FLDEstimator(index, JDeviceIndex.from_host(index))
    mapper = Mapper(index, MapConfig(paired_end=True), device="cpu")
    assert mapper.make_fld_estimator().device_index is mapper.device_index
    got = fld.FLDEstimator(index, mapper.device_index)
    # the fixture's batches, repeated up to the estimator's sampling depth
    batches = _batches(c1, c2)
    fed = [batches[i % len(batches)] for i in range(fld.SAMPLE_BATCHES)]
    for b in fed:
        want.feed(b)
        got.feed(b)
    assert not got.active and got.fld_tid is None
    got.feed(fed[0])  # past the sampling depth: ignored
    np.testing.assert_array_equal(got.hist.numpy(), np.asarray(want.hist))

    hist = got.hist.numpy().astype(np.int64)
    hist[0] = 0
    fdict = orc.build_fld_dict(seqs, index.k)
    o_hist = sum(orc.estimate_fld(b.codes, b.codes2, fdict, index.k,
                                  offsets=fld.DEFAULT_OFFSETS,
                                  max_len=fld.MAX_LEN)
                 for b in fed)
    np.testing.assert_array_equal(hist, o_hist)
    assert got.estimate() == want.estimate()
    mean, sd, n = got.estimate()
    assert n > 1000 and abs(mean - MEAN) < 10.0 and abs(sd - SD) < 8.0


def test_fld_step_ragged_mates_equals_jax(setup):
    """Mates of mixed lengths (some shorter than the last sampled offset
    needs, some with N bases, a few too short for any window) in one
    length bucket: the histogram of one step equals JAX fld_step's."""
    index, _, _, c1, c2 = setup
    rng = np.random.default_rng(8)
    B = c1.shape[1]
    codes1, codes2 = c1[0].copy(), c2[0].copy()
    len1 = rng.integers(20, L + 1, size=B).astype(np.int32)
    len2 = rng.integers(20, L + 1, size=B).astype(np.int32)
    for codes, ln in ((codes1, len1), (codes2, len2)):
        for i, n in enumerate(ln):
            codes[i, n:] = 4
        codes[rng.random(codes.shape) < 0.01] = 4
    di = JDeviceIndex.from_host(index)
    max_len = 600
    S = index.main_slots
    want = jfld.fld_step(di.table, jnp.asarray(index.fld_tid[:S]),
                         jnp.asarray(index.fld_pos[:S]),
                         jnp.zeros(max_len + 1, jnp.int32),
                         jnp.asarray(codes1), jnp.asarray(len1),
                         jnp.asarray(codes2), jnp.asarray(len2),
                         index.k, index.main_slots, index.bucket)
    tdi = DeviceIndex.from_host(index, "cpu")
    p1, b1 = (torch.from_numpy(a) for a in enc.pack_codes_2bit(codes1))
    p2, b2 = (torch.from_numpy(a) for a in enc.pack_codes_2bit(codes2))
    got = fld.fld_step(
        tdi.table, torch.from_numpy(index.fld_tid[:S]),
        torch.from_numpy(index.fld_pos[:S]),
        torch.zeros(max_len + 1, dtype=torch.int32), p1, b1,
        torch.from_numpy(len1), p2, b2, torch.from_numpy(len2), L, index.k,
        index.main_slots, index.bucket)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 100 < int(got.sum()) < B


def test_estimator_needs_payload_and_pairs(setup):
    index, _, _, c1, _ = setup
    tdi = DeviceIndex.from_host(index, "cpu")
    est = fld.FLDEstimator(index, tdi)
    B = c1.shape[1]
    est.feed(ReadBatch(codes=c1[0], lengths=np.full(B, L, np.int32),
                       weights=np.ones(B, np.int32)))  # single-end: ignored
    assert est.active and int(est.hist.sum()) == 0 and est.estimate() is None
    no_payload = type(index)(**{**index.__dict__, "fld_tid": None,
                                "fld_pos": None})
    with pytest.raises(ValueError, match="FLD payload"):
        fld.FLDEstimator(no_payload, tdi)
    assert Mapper(no_payload, MapConfig(), device="cpu"
                  ).make_fld_estimator() is None


def test_quantifier_estimates_fld_as_jax(setup):
    """A paired Quantifier with estimate_fld: the same (mean, sd, samples)
    as the JAX Quantifier's, the estimate drives the effective lengths, and
    est_counts agree within the pipeline test's bound."""
    index, _, _, c1, c2 = setup
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=2048, sig_table_bits=14, paired_end=True),
        em=EMConfig(estimate_fld=True, rel_tol=1e-6, max_iters=3000))
    want = JQuantifier(index, cfg).quantify_batches(iter(_batches(c1, c2)))
    got = Quantifier(index, cfg, device="cpu").quantify_batches(
        iter(_batches(c1, c2)))
    assert got.fld_mean is not None
    assert (got.fld_mean, got.fld_sd, got.fld_samples) == (
        want.fld_mean, want.fld_sd, want.fld_samples)
    em_cfg = EMConfig(mean_fragment_length=got.fld_mean,
                      fragment_length_sd=got.fld_sd)
    np.testing.assert_allclose(got.eff_length,
                               orc.effective_lengths(index.lengths, em_cfg),
                               rtol=1e-4)
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=5e-3,
                               atol=5e-2)
    assert got.bootstrap_counts is None


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory, setup):
    index, names, seqs, c1, c2 = setup
    tmp = tmp_path_factory.mktemp("torch_fld_cli")
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    for name, codes in (("r1.fq", c1[0]), ("r2.fq", c2[0])):
        write_fastq(str(tmp / name),
                    [r.tobytes().decode() for r in acgt[codes]])
    write_fasta(str(tmp / "ref.fa"), names, seqs)
    index.save(str(tmp / "index.npz"))
    return tmp


def test_cli_paired_fld_equals_jax_cli(cli_world):
    """A paired infer without fragment flags writes the same
    run_info["fld"] as the JAX CLI; with a fragment flag, none."""
    tmp = cli_world
    argv = [str(tmp / "index.npz"), None, str(tmp / "r1.fq"), "--mates",
            str(tmp / "r2.fq"), "--batch-size", "1024",
            "--sig-table-bits", "14"]
    infos = []
    for main, out, extra in ((jcli.main, "jax_out", []),
                             (cli.main, "port_out", ["--device", "cpu"]),
                             (cli.main, "port_fixed", [
                                 "--device", "cpu", "--fragment-sd", "20"])):
        a = list(argv)
        a[1] = str(tmp / out)
        assert main(["infer", *a, *extra]) == 0
        infos.append(json.load(open(tmp / out / "run_info.json")))
    want, got, fixed = infos
    assert got["fld"] is not None and got["fld"]["samples"] > 500
    assert got["fld"] == want["fld"]
    assert got["bootstrap_samples"] == want["bootstrap_samples"] == 0
    assert fixed["fld"] is None
    assert not os.path.exists(tmp / "port_out" / "bootstrap.npz")
