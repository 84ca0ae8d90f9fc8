"""The port's tracing hooks (``utils/profiling``, ``utils/metrics``) on the
CPU: no trace without a directory, a Chrome-trace JSON with the pipeline's
stage ranges (those ``run_info.json``'s timings time, and ingest and upload
from the prefetch thread) with one, and a failed write raising; every span
of a call both a range and a timer, children inside their parents, the
stages covering the call's wall, and the counters beside them."""

import json
import math
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch.map.driver import Mapper
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.ops.probe import device_table_layout
from seekmer_tpu_torch.utils import profiling
from seekmer_tpu_torch.utils.metrics import Metrics
from seekmer_tpu_torch.utils.prefetch import prefetch
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)

STAGES = ("map", "resolve", "em", "bootstrap", "ingest", "upload")
# the spans of a call, once each; the top-level ones cover its wall
ONCE = ("quantify", "mapper", "index_layout", "index_upload", "finalize",
        "readback", "merge", "ec_table", "resample", "collect")
TOP = ("mapper", "map", "resolve", "ec_table", "em", "bootstrap", "collect")
BATCH = 128


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)
    names, seqs = random_transcriptome(rng, num_transcripts=30)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100)
    fq = str(tmp_path_factory.mktemp("prof") / "reads.fq")
    write_fastq(fq, sim.reads1)
    return port_index(index), fq


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """600 pairs on the world's index (FLD estimated), as FASTQ files and
    as reads in memory."""
    rng = np.random.default_rng(12)
    names, seqs = random_transcriptome(rng, num_transcripts=30)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100,
                         paired=True)
    d = tmp_path_factory.mktemp("pairs")
    fq = [str(d / "r1.fq"), str(d / "r2.fq")]
    write_fastq(fq[0], sim.reads1)
    write_fastq(fq[1], sim.reads2)
    return port_index(index), fq, (sim.reads1, sim.reads2)


def _quantify(entry, world, pairs):
    """A quantifier call by ``entry``: the files of single-end reads or of
    pairs, or the pairs held in memory. Returns (index, result)."""
    paired = entry != "files_se"
    index = pairs[0] if paired else world[0]
    cfg = port_config(PipelineConfig().replace(
        map=MapConfig(batch_size=BATCH, sig_table_bits=12,
                      paired_end=paired),
        em=EMConfig(rel_tol=1e-6, bootstrap_samples=2)))
    q = Quantifier(index, cfg, device="cpu")
    if entry == "files_se":
        return index, q.quantify_files([world[1]])
    if entry == "files_pe":
        return index, q.quantify_files(pairs[1][:1],
                                       mate_paths=pairs[1][1:])
    return index, q.quantify_reads(*pairs[2])


ENTRIES = ["files_se", "files_pe", "reads_pe"]
# a one-card paired call's timings with the FLD estimated, bootstrap
# replicates and a checkpoint: every span's timer, every counter
ONE_CARD_KEYS = {
    "mapper_s", "index_upload_s", "index_layout_s", "map_s", "map_wait_s",
    "fld_s", "finalize_s", "readback_s", "merge_s", "resolve_s",
    "intersect_s", "ec_table_s", "em_s", "bootstrap_s", "resample_s",
    "collect_s", "ingest_s", "upload_s", "pack_s", "wall_s", "batches",
    "bootstrap_iterations", "classes", "complex_fragments",
    "distinct_signatures", "em_iterations", "em_iterations_per_s",
    "empty_intersection_fragments", "index_upload_bytes",
    "intersect_members", "intersect_on_device", "multi_ec_signatures",
    "multi_gene_classes", "nnz", "readback_bytes", "reads", "reads_per_s"}


def _names(path):
    with open(path) as fh:
        return [e.get("name") for e in json.load(fh)["traceEvents"]]


def test_maybe_trace_without_a_directory_is_a_no_op(tmp_path):
    for d in (None, ""):
        with profiling.maybe_trace(d, "x"):
            with profiling.annotate("inside"):
                torch.ones(3).sum()
    assert not os.listdir(tmp_path)


def test_quantifier_stages_are_trace_ranges(world, tmp_path):
    """A traced quantify_files: one trace file holding the label and every
    stage range, ingest and upload once a batch."""
    index, fq = world
    cfg = port_config(PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12),
        em=EMConfig(rel_tol=1e-6, bootstrap_samples=2)))
    d = str(tmp_path / "trace")
    with profiling.maybe_trace(d, "run"):
        res = Quantifier(index, cfg, device="cpu").quantify_files([fq])
    assert os.listdir(d) == ["run.trace.json"]
    names = _names(profiling.trace_path(d, "run"))
    assert names.count("run") == 1
    for stage in ("map", "resolve", "em", "bootstrap"):
        assert names.count(stage) == 1, stage
    batches = -(-res.total_reads // 128)
    assert names.count("upload") == batches
    assert names.count("ingest") == batches + 1  # the last finds the end


@pytest.mark.parametrize("entry", ENTRIES)
def test_call_spans_are_trace_ranges(world, pairs, tmp_path, entry):
    """A traced call holds the range ``quantify`` around it and each of its
    spans once, ``fld`` on the paired batches it samples, and ``pack`` and
    ``map_wait`` once a batch (the last wait finds the end)."""
    d = str(tmp_path / "trace")
    with profiling.maybe_trace(d, "run"):
        _, res = _quantify(entry, world, pairs)
    names = Counter(_names(profiling.trace_path(d, "run")))
    for span in ONCE:
        assert names[span] == 1, span
    batches = -(-res.total_reads // BATCH)
    assert names["pack"] == batches
    assert names["map_wait"] == batches + 1
    assert (names["fld"] > 0) == (entry != "files_se")


@pytest.mark.parametrize("entry", ENTRIES)
def test_timings_carry_every_span_and_counter(world, pairs, monkeypatch,
                                              entry):
    """Every span is a timer in ``timings``, a child within its parent;
    the top-level stages cover 0.9-1.0 of ``wall_s``; the counters count
    the batches fed, the merged signatures and the index's bytes as laid
    out."""
    finalized = []
    real = Mapper.finalize

    def spy(self):
        finalized.append(real(self))
        return finalized[-1]

    monkeypatch.setattr(Mapper, "finalize", spy)
    index, res = _quantify(entry, world, pairs)
    t = res.timings
    spans = set(ONCE + TOP + ("map_wait", "pack", "ingest", "upload")) - {
        "quantify"}
    if entry != "files_se":
        spans.add("fld")
    for span in spans:
        assert t[f"{span}_s"] >= 0.0, span
    for child, parent in (("finalize", "map"), ("readback", "finalize"),
                          ("merge", "finalize"), ("map_wait", "map"),
                          ("resample", "bootstrap"), ("pack", "upload")):
        assert t[f"{child}_s"] <= t[f"{parent}_s"], child
    assert t["index_layout_s"] + t["index_upload_s"] <= t["mapper_s"]
    if entry != "files_se":
        assert t["fld_s"] <= t["map_s"]
    assert t["readback_s"] + t["merge_s"] <= t["finalize_s"]
    top = sum(t[f"{s}_s"] for s in TOP)
    assert 0.9 * t["wall_s"] <= top <= t["wall_s"]
    assert t["batches"] == math.ceil(res.total_reads / BATCH)
    (result,) = finalized
    assert t["distinct_signatures"] == result.sigs.shape[0]
    assert t["index_upload_bytes"] == sum(
        device_table_layout(a, index.bucket).nbytes
        for a in (index.table, index.stash)) + (
            index.ec_offsets.nbytes + index.ec_transcripts.nbytes)
    assert t["readback_bytes"] > 0
    assert 0 <= t["multi_ec_signatures"] <= t["distinct_signatures"]
    assert t["classes"] > 0 and t["nnz"] >= t["classes"]


def test_span_is_a_timer_and_a_range(tmp_path):
    """``Metrics.span`` adds to its timer on every exit, a raise too, and
    names a range in the trace each time."""
    m = Metrics()
    d = str(tmp_path / "t")
    with profiling.maybe_trace(d, "x"):
        for _ in range(3):
            with m.span("step"):
                torch.ones(3).sum()
        with pytest.raises(ValueError):
            with m.span("step"):
                raise ValueError
    assert Counter(_names(profiling.trace_path(d, "x")))["step"] == 4
    assert m.snapshot()["step_s"] > 0.0


def test_metrics_updated_from_many_threads_add_up():
    """Counters and timers that more threads than cores update at once,
    switching as often as the interpreter allows, lose no update."""
    m = Metrics()
    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 2000

    def work():
        for _ in range(n):
            m.count("n")
            with m.timer("t"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert m.counters["n"] == n_threads * n
    assert m.timings["t"] > 0.0


def test_prefetch_times_its_waits():
    """``map_wait`` times every wait of the consumer, the end's too."""
    m = Metrics()
    assert list(prefetch(range(5), depth=2, metrics=m)) == list(range(5))
    assert m.timings["map_wait"] > 0.0


def test_trace_write_failure_raises(tmp_path):
    """A directory that cannot be made, and a trace file that cannot be
    written, raise."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        with profiling.maybe_trace(str(blocker), "x"):
            torch.ones(3).sum()
    os.makedirs(profiling.trace_path(str(tmp_path / "d"), "x"))
    with pytest.raises(OSError):
        with profiling.maybe_trace(str(tmp_path / "d"), "x"):
            torch.ones(3).sum()


def test_one_card_timings_keys(pairs, tmp_path):
    """A one-card paired ``quantify_files`` with the FLD estimated,
    bootstrap replicates and a checkpoint reports exactly this set of
    spans and counters."""
    index, fq, _ = pairs
    cfg = port_config(PipelineConfig().replace(
        map=MapConfig(batch_size=BATCH, sig_table_bits=12, paired_end=True),
        em=EMConfig(rel_tol=1e-6, bootstrap_samples=2)))
    res = Quantifier(index, cfg, device="cpu").quantify_files(
        fq[:1], mate_paths=fq[1:], checkpoint_path=str(tmp_path / "c.npz"),
        checkpoint_every=2)
    assert res.fld_mean is not None and res.bootstrap_counts is not None
    assert set(res.timings) == ONE_CARD_KEYS
