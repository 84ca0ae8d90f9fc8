"""The port's tracing hooks (``utils/profiling``) on the CPU: no trace
without a directory, a Chrome-trace JSON with the pipeline's stage ranges
(those ``run_info.json``'s timings time, and ingest and upload from the
prefetch thread) with one, and a failed write raising."""

import json
import os

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.utils import profiling
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)

STAGES = ("map", "resolve", "em", "bootstrap", "ingest", "upload")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)
    names, seqs = random_transcriptome(rng, num_transcripts=30)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100)
    fq = str(tmp_path_factory.mktemp("prof") / "reads.fq")
    write_fastq(fq, sim.reads1)
    return port_index(index), fq


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
