"""Rank functions of the port's multi-process tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_ckpt_mp.py``,
``tests/test_torch_prefix_shard.py``), run
by ``seekmer_tpu_torch.parallel.comm.launch``. Spawned ranks import this
module, so it imports neither JAX nor ``seekmer_tpu``
(``tests/test_torch_self_contained.py`` scans it); the JAX references are
computed in the test process.
"""

import os

import torch

from seekmer_tpu_torch.config import ShardConfig
from seekmer_tpu_torch.em import em as tem
from seekmer_tpu_torch.em.em import build_ec_table
from seekmer_tpu_torch.io import fastq as tfastq
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.parallel import bootstrap_shard, comm
from seekmer_tpu_torch.parallel.bootstrap_shard import run_bootstrap_sharded
from seekmer_tpu_torch.parallel.data_parallel import DataParallelMapper
from seekmer_tpu_torch.utils import checkpoint as tckpt

# a rank's batches hold a cursor every few reads in the checkpoint tests
CHUNK = 100


class Crash(Exception):
    """Stops every rank at the same collective point."""


def _batches(reads, mates, cfg):
    if mates is None:
        return tfastq.batch_reads(reads, cfg)
    return tfastq.batch_read_pairs(zip(reads, mates), cfg)


def dp_map(mapper: DataParallelMapper, reads, mates):
    """Map this rank's share of the batches, sampling the FLD as the
    quantifier does; returns (MapResult, this rank's FLD histogram, the
    summed one) (histograms None for single-end reads)."""
    est = mapper.make_fld_estimator() if mates is not None else None
    for b in mapper.select(_batches(reads, mates, mapper.cfg)):
        if est is not None and est.active:
            est.feed(b)
        mapper.feed(b)
    res = mapper.finalize()
    if est is None:
        return res, None, None
    return res, est.hist.numpy().copy(), mapper.fld_histogram()


def suite(rank, device, index, reads, mates, map_cases, em_cfgs,
          boot_case):
    """The map modes, the quantifier's EM and the sharded bootstrap on one
    group. ``map_cases``: [(name, MapConfig, paired)]; ``em_cfgs``:
    [(name, PipelineConfig)], each quantifying ``reads`` on every rank
    (its ``shard`` set to the group); ``boot_case``: (member lists,
    counts, an EMConfig with bootstrap_samples), or None."""
    out = {"rank": rank, "world": comm.world(), "spans": {}}
    shard = ShardConfig(data_axis=comm.world())
    for name, cfg, paired in map_cases:
        mapper = DataParallelMapper(index, cfg, shard, device=device)
        out[name] = dp_map(mapper, reads, mates if paired else None)
        out["spans"][name] = dict(mapper.metrics.timings)
    for name, cfg in em_cfgs:
        res = Quantifier(index, cfg.replace(shard=shard),
                         device).quantify_reads(reads)
        out[name] = (res.est_counts, res.em_iterations)
    if boot_case is not None:
        members, counts, boot_cfg = boot_case
        ec = build_ec_table(members, counts, index.num_transcripts,
                            device=device)
        runs = [run_bootstrap_sharded(ec, index.lengths, boot_cfg)
                for _ in range(2)]
        out["boot"] = [(b.numpy(), it) for b, it in runs]
    return out


def suite_both(rank, device, index, reads, r1, r2, cases, em_cfgs, boot):
    """``suite`` with the single-end cases on ``reads`` and the paired
    ones on (r1, r2)."""
    out = suite(rank, device, index, reads, None,
                [c for c in cases if not c[2]], em_cfgs, boot)
    paired = suite(rank, device, index, r1, r2,
                   [c for c in cases if c[2]], [], None)
    out["spans"].update(paired.pop("spans"))
    out.update(paired)
    return out


def fail_on_rank1(rank, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.barrier()


def skip_a_collective(rank, device):
    """Rank 1 leaves without joining the barrier rank 0 waits in."""
    if rank == 0:
        comm.barrier()


def cli_infer(rank, device, argvs, envs=None):
    """``cli.main(argvs[rank])`` inside the group that ``launch`` made
    (``infer --distributed`` takes it as it is), with ``envs[rank]`` in
    the environment (torchrun's ``LOCAL_RANK``...)."""
    from seekmer_tpu_torch import cli

    if envs is not None:
        os.environ.update(envs[rank])
    return cli.main(argvs[rank])


def _quant(index, cfg, device, files, **kw):
    r1, r2 = files
    return Quantifier(index, cfg, device).quantify_files(
        [r1], [r2] if r2 else None, **kw)


def _crash_after(owner, name, calls):
    """Make ``owner.name`` (a class's method or a module's function) raise
    Crash after its ``calls``-th call (every rank calls it at the same
    points); returns the undo."""
    real = getattr(owner, name)
    seen = [0]

    def wrapped(*a, **k):
        out = real(*a, **k)
        seen[0] += 1
        if seen[0] == calls:
            raise Crash
        return out

    setattr(owner, name, wrapped)
    return lambda: setattr(owner, name, real)


def _interrupted(fn, owner, name, calls):
    undo = _crash_after(owner, name, calls)
    try:
        fn()
        raise AssertionError(f"{owner.__name__}.{name} never stopped the "
                             "run")
    except Crash:
        pass
    finally:
        undo()


def _refusal(fn):
    """The ValueError that ``fn`` raises on this rank (every rank must)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("the run was not refused")


def ckpt_suite(rank, device, index, cfg, boot_cfg, files, work):
    """A checkpointed run stopped after its first map save and resumed; a
    sidecar of the wrong step, then a missing one, refused on every rank;
    EM stopped after its second snapshot and resumed; the bootstrap
    likewise. Returns the runs' QuantResults and the refusals."""
    tfastq.CheckpointableBatchSource.CHUNK = CHUNK
    tem.SYNC_TARGET_S = 0.0
    tckpt.SNAPSHOT_MIN_INTERVAL_S = 0.0
    out = {"plain": _quant(index, cfg, device, files)}
    ckpt = os.path.join(work, "map.ckpt.npz")
    run = lambda: _quant(index, cfg, device, files,  # noqa: E731
                         checkpoint_path=ckpt, checkpoint_every=1)
    _interrupted(run, DataParallelMapper, "save_checkpoint", 1)
    out["stopped_step"] = tckpt.load_host_cursor(ckpt, rank)[2]
    out["resumed"] = run()
    # the finished checkpoint, its sidecar of rank 1 a step ahead
    comm.barrier()
    side = tckpt.host_cursor_path(ckpt, 1)
    if rank == 1:
        cursor, total, step, fld = tckpt.load_host_cursor(ckpt, 1)
        os.rename(side, side + ".good")
        tckpt.save_host_cursor(ckpt, 1, cursor, total, step + 1, fld)
    comm.barrier()
    out["step_refusal"] = _refusal(run)
    comm.barrier()
    if rank == 1:
        os.replace(side + ".good", side)
    if rank == 0:
        os.remove(tckpt.host_cursor_path(ckpt, 0))
    comm.barrier()
    out["missing_refusal"] = _refusal(run)

    ckpt2 = os.path.join(work, "em.ckpt.npz")
    run2 = lambda: _quant(index, cfg, device, files,  # noqa: E731
                          checkpoint_path=ckpt2)
    _interrupted(run2, tem, "convergence_check", 3)
    snap = tckpt.load_em_snapshot(ckpt2 + ".em.npz") if rank == 0 else None
    out["em_snapshot_it"] = None if snap is None else snap[1]
    out["em_resumed"] = run2()

    ckpt3 = os.path.join(work, "boot.ckpt.npz")
    run3 = lambda: _quant(index, boot_cfg, device, files,  # noqa: E731
                          checkpoint_path=ckpt3)
    out["boot_plain"] = _quant(index, boot_cfg, device, files)

    _interrupted(run3, bootstrap_shard.Exchange, "__call__", 3)
    snap = (tckpt.load_em_snapshot(ckpt3 + ".boot.npz") if rank == 0
            else None)
    out["boot_snapshot_it"] = None if snap is None else snap[1]
    out["boot_resumed"] = run3()
    comm.barrier()  # rank 0 has deleted the stage snapshots by now
    out["snapshots_left"] = sorted(
        f for f in os.listdir(work) if f.endswith((".em.npz", ".boot.npz")))
    return out



# ---- the prefix-sharded index (tests/test_torch_prefix_shard.py) ---------


def ps_map(mapper, batches, fld: bool):
    """Map this rank's rows of ``batches`` with a prefix-sharded mapper,
    sampling the FLD against shard 0 as the quantifier does; returns
    (MapResult, extra routing rounds, this rank's FLD histogram, the
    summed one) (histograms None without ``fld``)."""
    est = mapper.make_fld_estimator() if fld else None
    for b in mapper.select(batches):
        if est is not None and est.active:
            est.feed(b)
        mapper.feed(b)
    res = mapper.finalize()
    if est is None:
        return res, mapper.extra_routing_rounds, None, None
    return (res, mapper.extra_routing_rounds, est.hist.numpy().copy(),
            mapper.fld_histogram())


def ps_suite(rank, device, index, cases):
    """``cases``: [(name, MapConfig, ShardConfig, capacity_factor, reads,
    mates, fld)], each mapped by a ``PrefixShardedMapper`` on this group
    (the ShardConfigs lay out the same number of ranks)."""
    from seekmer_tpu_torch.parallel.prefix_shard import PrefixShardedMapper

    out = {"rank": rank, "world": comm.world()}
    for name, cfg, shard, cf, reads, mates, fld in cases:
        mapper = PrefixShardedMapper(index, cfg, shard, device=device,
                                     capacity_factor=cf)
        out[name] = ps_map(mapper, _batches(reads, mates, cfg), fld)
    return out


def ps_ckpt(rank, device, index, cfg, files, work):
    """A prefix-sharded run checkpointed every batch, stopped after its
    first save and resumed, beside the run without a checkpoint; returns
    the (uninterrupted, resumed) QuantResults and the stopped run's
    sidecar (cursor, read count, step)."""
    from seekmer_tpu_torch.parallel.prefix_shard import PrefixShardedMapper

    tfastq.CheckpointableBatchSource.CHUNK = CHUNK
    plain = _quant(index, cfg, device, files)
    ckpt = os.path.join(work, "ps.ckpt.npz")
    run = lambda: _quant(index, cfg, device, files,  # noqa: E731
                         checkpoint_path=ckpt, checkpoint_every=1)
    _interrupted(run, PrefixShardedMapper, "save_checkpoint", 1)
    stopped = tckpt.load_host_cursor(ckpt, rank)[:3]
    return plain, run(), stopped
