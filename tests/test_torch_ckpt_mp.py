"""Multi-process checkpoints of the port on the CPU (2 ranks over gloo, one
launch under a hard deadline): a paired run checkpointed every round and
stopped after its first save resumes to the uninterrupted run's bits; a
sidecar of another step, then a missing one, is refused on every rank
within the deadline; EM and the sharded bootstrap stopped after their
second snapshot resume from rank 0's snapshot, broadcast to both ranks,
to the uninterrupted bits; the two-rank run equals the one-rank
Quantifier's. Also the files' layout (``parallel/ckpt_mp.py``): one
stacked table in the JAX package's keys, a sidecar a rank."""

import dataclasses

import numpy as np
import pytest
import torch

from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.utils import checkpoint as jckpt
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch.config import (EMConfig, MapConfig, PipelineConfig,
                                      ShardConfig)
from seekmer_tpu_torch.io import fastq as tfastq
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.parallel import comm
from seekmer_tpu_torch.utils import checkpoint as tckpt
from tests import torch_parallel_workers as workers
from tests.test_torch_self_contained import port_index

torch.set_num_threads(1)

DEADLINE_S = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The checkpoint suite on 2 ranks, and the one-rank runs."""
    tmp = tmp_path_factory.mktemp("torch_ckpt_mp")
    rng = np.random.default_rng(77)
    names, seqs = random_transcriptome(rng, num_transcripts=40,
                                       min_len=300, max_len=1000,
                                       shared_prefix_frac=0.5)
    index = port_index(build_index_from_seqs(names, seqs))
    pairs = simulate_reads(rng, seqs, num_reads=700, read_len=100,
                           paired=True, mean_frag=210.0, sd_frag=20.0)
    files = (str(tmp / "r1.fq"), str(tmp / "r2.fq"))
    write_fastq(files[0], pairs.reads1)
    write_fastq(files[1], pairs.reads2)
    one = PipelineConfig().replace(
        map=MapConfig(batch_size=64, sig_table_bits=11, paired_end=True),
        em=EMConfig(rel_tol=1e-6))
    two = one.replace(shard=ShardConfig(data_axis=2))
    boot = dataclasses.replace(two.em, bootstrap_samples=4,
                               bootstrap_seed=5)
    work = tmp / "work"
    work.mkdir()
    outs = comm.launch(2, workers.ckpt_suite, (
        index, two, two.replace(em=boot), files, str(work)),
        timeout_s=DEADLINE_S)
    one_rank = Quantifier(index, one, "cpu").quantify_files(
        [files[0]], [files[1]])
    one_boot = Quantifier(index, one.replace(em=boot), "cpu"
                          ).quantify_files([files[0]], [files[1]])
    return outs, one_rank, one_boot, work


def _same(a, b, boot=False):
    assert (a.total_reads, a.mapped, a.unmapped, a.em_iterations) == (
        b.total_reads, b.mapped, b.unmapped, b.em_iterations)
    assert (a.fld_mean, a.fld_sd, a.fld_samples) == (
        b.fld_mean, b.fld_sd, b.fld_samples)
    np.testing.assert_array_equal(a.est_counts, b.est_counts)
    assert a.log_likelihood == b.log_likelihood
    if boot:
        np.testing.assert_array_equal(a.bootstrap_counts, b.bootstrap_counts)


def test_two_ranks_equal_one_rank(run):
    """The uninterrupted 2-rank run: the one-rank Quantifier's counts,
    FLD estimate (fault 5) and est_counts bits on both ranks."""
    outs, one_rank, _, _ = run
    assert one_rank.fld_samples is not None
    for out in outs:
        _same(out["plain"], one_rank)


def test_map_checkpoint_resume(run):
    """Stopped after the first save (step 1, global batches 0-1), resumed
    on both ranks: the uninterrupted run's bits."""
    outs, _, _, _ = run
    for out in outs:
        assert out["stopped_step"] == 1
        _same(out["resumed"], out["plain"])


@pytest.mark.parametrize("key,words", [
    ("step_refusal", ("step", "rank(s) [1]")),
    ("missing_refusal", ("missing", "rank(s) [0]")),
])
def test_inconsistent_sidecar_refused_on_every_rank(run, key, words):
    """One rank's bad sidecar makes every rank raise at the restore: the
    rank that found it names it, the other names that rank."""
    outs, _, _, _ = run
    msgs = [out[key] for out in outs]
    assert any(words[0] in m for m in msgs)
    assert any(words[1] in m for m in msgs)


def test_em_snapshot_broadcast_and_resume(run):
    """EM stopped at its third block's convergence test on every rank:
    rank 0 had written its snapshot at iteration 32; both ranks resume
    from it (broadcast) to the uninterrupted run's bits and iteration
    count."""
    outs, _, _, _ = run
    assert outs[0]["em_snapshot_it"] == 32
    assert outs[1]["em_snapshot_it"] is None  # only rank 0 reads it
    for out in outs:
        _same(out["em_resumed"], out["plain"])


def test_bootstrap_snapshot_resume(run):
    """The sharded bootstrap stopped after its second snapshot resumes
    (EM skipped by its converged pin) to the uninterrupted replicates; a
    finished run leaves no stage snapshot."""
    outs, _, one_boot, _ = run
    assert outs[0]["boot_snapshot_it"] == 32
    for out in outs:
        _same(out["boot_resumed"], out["boot_plain"], boot=True)
        _same(out["boot_plain"], one_boot)
        assert out["snapshots_left"] == []
    b = outs[0]["boot_plain"].bootstrap_counts
    np.testing.assert_allclose(b.sum(axis=1), outs[0]["boot_plain"].mapped,
                               rtol=1e-4)


def test_checkpoint_layout(run):
    """One table file, the ranks' tables stacked, total_reads -1 (the JAX
    package loads it as its own multi-process save), and a sidecar a rank
    with its cursor, reads and FLD state at the table's step."""
    outs, _, _, work = run
    ckpt = str(work / "em.ckpt.npz")
    table, total, cursor, fld, step = tckpt.load_map_checkpoint(
        ckpt, "cpu", with_step=True, multiprocess=True)
    assert total == -1 and cursor is None and fld is None
    rows = (1 << 11) + 1
    assert table.count.shape == (2 * rows,) and table.overflow.shape == (2,)
    jt, jtotal, _, jstep = jckpt.load_map_checkpoint(ckpt, with_step=True)
    assert jtotal == -1 and jstep == step
    np.testing.assert_array_equal(jt.count, table.count.numpy())
    reads = 0
    for r in range(2):
        c, n, s, f = tckpt.load_host_cursor(ckpt, r)
        assert s == step and c["batch"] > 0 and f[1] == 2
        reads += n
        assert jckpt.load_host_cursor(ckpt, r)[1:] == (n, s)
    assert reads == outs[0]["plain"].total_reads


def test_rank_batches_cursor_is_exact(run, tmp_path):
    """Each rank resumes from its kept batches' cursors without a batch
    twice or lost: at every cursor, the rest of the stream from a fresh
    source restored there deals each rank exactly its remaining batches."""
    _, _, _, work = run
    cfg = MapConfig(batch_size=64, paired_end=True)
    files = ([str(work.parent / "r1.fq")], [str(work.parent / "r2.fq")])
    src = tfastq.CheckpointableBatchSource(*files, cfg)
    src.CHUNK = 100
    whole = [b.weights.copy() for b in src]
    n = len(whole)
    assert n >= 6
    for rank in range(2):
        src = tfastq.CheckpointableBatchSource(*files, cfg)
        src.CHUNK = 100
        kept = list(tfastq.rank_batches(src, rank, 2))
        assert len(kept) == len(range(rank, n, 2))
        for i, b in enumerate(kept[:-1]):
            if b.cursor is None:
                continue
            again = tfastq.CheckpointableBatchSource(*files, cfg)
            again.CHUNK = 100
            again.restore(b.cursor)
            rest = list(tfastq.rank_batches(again, rank, 2,
                                            b.cursor["batch"]))
            assert len(rest) == len(kept) - i - 1
            for x, y in zip(rest, kept[i + 1:]):
                np.testing.assert_array_equal(x.codes, y.codes)
