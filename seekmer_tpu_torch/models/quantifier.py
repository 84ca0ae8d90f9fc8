"""Quantifier: the end-to-end pipeline (index -> pseudoalignment -> EM ->
abundance table, with fragment-length estimation from paired reads and
bootstrap replicates) on one device; counterpart of
``seekmer_tpu/models/quantifier.py``, single-device path only.

Entry points: ``quantify_files`` (FASTQ files through the C ingest; with
``checkpoint_path`` through ``CheckpointableBatchSource``, serial, saving a
map checkpoint every ``checkpoint_every`` batches and EM and bootstrap
snapshots beside it; with ``pack_cache`` through the pre-packed batch
cache, ``io/pack_cache``), ``quantify_reads`` (reads held in memory) and
``quantify_batches``. A resume restores the map checkpoint and seeks the
inputs; an EM snapshot warm-starts EM, a converged one skips it, and a
bootstrap snapshot warm-starts the bootstrap. A completed run deletes its
stage snapshots. Stages are named ranges in a ``--trace-dir`` trace
(``utils/profiling.annotate``): map, resolve, em and bootstrap here, the
ones ``run_info.json``'s ``timings`` time, and ingest and upload on the
prefetch thread.

Several ranks (``PipelineConfig.shard.data_axis`` != 1, one process a card
in a ``torch.distributed`` group, ``parallel/comm.py``): every rank builds
a ``DataParallelMapper`` and maps its share of the batches (on one host
global batch g goes to rank g mod N; ``input_share`` narrows that to the
ranks given the same files), the merged map result and the summed FLD
histogram reach every rank, and every rank runs the one-card ``run_em``
on the merged table (the JAX package's nnz-sharded collective EM has no
counterpart: every rank holds the whole table, so sharding EM saves no
memory, and an exchange between ranks a block costs more than the block),
and the bootstrap is split over the ranks' replicates
(``parallel/bootstrap_shard.py``; on every rank in full when the ranks do
not divide ``bootstrap_samples``, as in the JAX package). A checkpoint's
restore is agreed: one rank's restore error makes every rank raise at the
same point, and either every rank resumes or none. Rank 0 alone writes
EM and bootstrap snapshots and deletes them; its snapshot reaches the
other ranks by a broadcast (``_broadcast_snapshot``). ``--pack-cache`` on
several ranks is refused, as the JAX package refuses it. Under the
prefix-sharded index (``shard.index_mode`` "prefix", ``index_axis`` > 1;
``parallel/prefix_shard.py``) every rank builds a ``PrefixShardedMapper``,
holds one shard of the index on its card and maps its rows of every
batch, routing lookups over its index group; what follows the map is the
same as above.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import zipfile
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import EMConfig, PipelineConfig
from ..em.bootstrap import run_bootstrap
from ..em.em import (
    build_ec_table,
    effective_lengths,
    log_likelihood,
    run_em,
    tpm_from_alpha,
)
from ..index.store import KMerIndex
from ..io.fastq import (
    CheckpointableBatchSource,
    ReadBatch,
    batch_read_pairs,
    batch_read_pairs_native,
    batch_reads,
    batch_reads_native,
)
from ..map.driver import Mapper, MapResult, check_device, resolve_signatures
from ..map.fld import estimate_from_hist
from ..parallel import comm
from ..parallel.bootstrap_shard import run_bootstrap_sharded
from ..parallel.data_parallel import DataParallelMapper, data_ranks
from ..parallel.prefix_shard import PrefixShardedMapper, prefix_ranks
from ..utils.checkpoint import load_em_snapshot, save_em_snapshot
from ..utils.metrics import Metrics
from ..utils.prefetch import device_put_batches, prefetch
from ..utils.profiling import annotate

log = logging.getLogger(__name__)


@dataclasses.dataclass
class QuantResult:
    est_counts: np.ndarray
    tpm: np.ndarray
    eff_length: np.ndarray
    names: np.ndarray
    lengths: np.ndarray
    total_reads: int
    mapped: int
    unmapped: int
    em_iterations: int
    bootstrap_counts: Optional[np.ndarray] = None  # [B, T]
    timings: Optional[Dict[str, float]] = None
    # fragment-length distribution estimated from mapped pairs (map/fld.py);
    # None when not estimated (single-end, no FLD payload, or too few
    # concordant unique-k-mer pairs)
    fld_mean: Optional[float] = None
    fld_sd: Optional[float] = None
    fld_samples: Optional[int] = None
    log_likelihood: Optional[float] = None


class Quantifier:
    # Minimum seconds between two periodic EM or bootstrap snapshots: the
    # fixed point syncs every ~2 s in pieces, and writing a config-scale
    # alpha at each would dominate. The pin after the EM stage bypasses it.
    SNAPSHOT_MIN_INTERVAL_S = 30.0

    def __init__(self, index: KMerIndex,
                 cfg: PipelineConfig = PipelineConfig(), device="cuda",
                 input_share: Optional[Tuple[int, int]] = None):
        """``input_share``: with several ranks, (this rank's place, the
        number of ranks) among those given the same files, which deal
        that input's batches (``--distributed``: a host's ranks); None:
        every rank of the group reads the whole input."""
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg
        self.input_share = input_share
        shard = cfg.shard
        self.prefix = shard.index_mode == "prefix" and shard.index_axis != 1
        if shard.index_axis != 1 and not self.prefix:
            raise ValueError(f"index_axis {shard.index_axis} takes the "
                             "prefix-sharded index (index_mode='prefix')")
        if self.prefix:
            self.ranks = prefix_ranks(shard)
        else:
            self.ranks = 1 if shard.data_axis == 1 else data_ranks(shard)

    def _make_mapper(self) -> Mapper:
        if self.prefix:
            return PrefixShardedMapper(self.index, self.cfg.map,
                                       self.cfg.shard, device=self.device,
                                       input_share=self.input_share)
        if self.ranks > 1:
            return DataParallelMapper(self.index, self.cfg.map,
                                      self.cfg.shard, device=self.device,
                                      input_share=self.input_share)
        return Mapper(self.index, self.cfg.map, device=self.device)

    def _native_batches(self, fastq_paths, mate_paths):
        if mate_paths:
            return batch_read_pairs_native(fastq_paths, mate_paths,
                                           self.cfg.map)
        return batch_reads_native(fastq_paths, self.cfg.map)

    def quantify_files(self, fastq_paths: List[str],
                       mate_paths: Optional[List[str]] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 50,
                       pack_cache: Optional[str] = None) -> QuantResult:
        """Quantify FASTQ(.gz) files through the C ingest. With
        ``checkpoint_path`` the files are read serially through
        ``CheckpointableBatchSource`` and the run resumes from the
        checkpoint there, if any; ``pack_cache`` (a directory, or "auto"
        for ``<first fastq>.smpack``) feeds batches from the pack cache,
        building it first when it is absent or stale."""
        mapper = self._make_mapper()
        if pack_cache is not None and self.ranks > 1:
            raise ValueError(
                "--pack-cache takes the single-card mapper (no "
                "--data-shards/--index-shards/--distributed): cached "
                "batches are pre-packed for one card's stream")
        if pack_cache is not None:
            return self._quantify_pack_cache(
                fastq_paths, mate_paths, checkpoint_path, checkpoint_every,
                pack_cache, mapper)
        if checkpoint_path:
            source = CheckpointableBatchSource(fastq_paths, mate_paths,
                                               self.cfg.map)
            mapper = self._restore(mapper, checkpoint_path, source)
            batches = iter(source)
        else:
            batches = self._native_batches(fastq_paths, mate_paths)
        return self.quantify_batches(batches, mapper=mapper,
                                     checkpoint_path=checkpoint_path,
                                     checkpoint_every=checkpoint_every)

    def _restore(self, mapper: Mapper, checkpoint_path: str,
                 source) -> Mapper:
        """Restore the map checkpoint, if any, into ``mapper`` and
        ``source``. A file without a cursor cannot resume: its table is
        dropped and the run starts fresh. Restore errors raise; on several
        ranks only after every rank has tried (``_agree_restore``)."""
        if self.ranks > 1:
            state = self._agree_restore(mapper, checkpoint_path)
        else:
            state = mapper.restore_checkpoint(checkpoint_path)
        if state:
            source.restore(state)
            log.info("resuming from checkpoint: %d reads already mapped",
                     mapper.total_reads)
        elif state is not None:
            log.warning("checkpoint %s has no stream cursor; starting fresh",
                        checkpoint_path)
            mapper = self._make_mapper()
        return mapper

    def _agree_restore(self, mapper, checkpoint_path: str):
        """The ranks' restores, agreed (the JAX package's protocol): a
        rank holds its restore error until every rank has reported, then
        every rank raises at the same point, so none goes on into a later
        collective alone. Resume is all or nothing: when some rank has no
        cursor to resume from, every rank starts fresh."""
        state, err = None, None
        try:
            state = mapper.restore_checkpoint(checkpoint_path)
        except (ValueError, OSError, KeyError,
                zipfile.BadZipFile) as e:  # raised below, once agreed
            err = e
        cats = comm.allgather(np.asarray(
            [state is None and err is None, bool(state), err is not None],
            np.int64))
        if cats[:, 2].any():
            if err is not None:
                raise err
            bad = np.flatnonzero(cats[:, 2]).tolist()
            raise ValueError(
                f"checkpoint {checkpoint_path} failed to restore on rank(s) "
                f"{bad} (see their errors); delete the checkpoint files to "
                "start fresh")
        if not cats[:, 1].all():
            if not cats[:, 0].all():
                log.warning("checkpoint %s is not resumable on every rank; "
                            "every rank starts fresh", checkpoint_path)
            state = None if cats[:, 0].all() else {}
        return state

    def _quantify_pack_cache(self, fastq_paths, mate_paths, checkpoint_path,
                             checkpoint_every, pack_cache, mapper
                             ) -> QuantResult:
        """A --pack-cache run: a complete cache is memory-mapped and fed
        directly (no decode, parse or pack); otherwise this run builds it
        by teeing the ingest stream. Cached batches carry resume cursors,
        so --checkpoint works on cached runs; during a build it is
        disabled (build batches have no cursor to resume from)."""
        from ..io.pack_cache import (PackCacheSource, cache_valid,
                                     default_cache_dir, write_through)

        map_cfg = self.cfg.map
        if not map_cfg.h2d_pack_2bit:
            raise ValueError("--pack-cache stores 2-bit-packed batches; "
                             "it cannot be combined with --no-h2d-pack")
        cache_dir = (default_cache_dir(fastq_paths) if pack_cache == "auto"
                     else pack_cache)
        if cache_valid(cache_dir, map_cfg, fastq_paths, mate_paths):
            log.info("pack cache hit: %s (skipping decode/parse/pack)",
                     cache_dir)
            source = PackCacheSource(cache_dir, map_cfg)
            if checkpoint_path:
                mapper = self._restore(mapper, checkpoint_path, source)
            batches = iter(source)
        else:
            if checkpoint_path:
                log.warning(
                    "pack cache at %s is absent or stale: building it this "
                    "run; --checkpoint is disabled during the build "
                    "(re-runs over the completed cache support it)",
                    cache_dir)
                checkpoint_path = None
            batches = write_through(
                self._native_batches(fastq_paths, mate_paths), cache_dir,
                map_cfg, fastq_paths, mate_paths)
        return self.quantify_batches(batches, mapper=mapper,
                                     checkpoint_path=checkpoint_path,
                                     checkpoint_every=checkpoint_every)

    def quantify_reads(self, reads: List[str],
                       mates: Optional[List[str]] = None) -> QuantResult:
        """Quantify reads held in memory (str or bytes), single-end or
        paired with ``mates``."""
        reads_b = [r.encode() if isinstance(r, str) else r for r in reads]
        if mates is not None:
            mates_b = [m.encode() if isinstance(m, str) else m for m in mates]
            batches = batch_read_pairs(zip(reads_b, mates_b), self.cfg.map)
        else:
            batches = batch_reads(reads_b, self.cfg.map)
        return self.quantify_batches(batches)

    def quantify_batches(self, batches: Iterable[ReadBatch],
                         mapper: Optional[Mapper] = None,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 50) -> QuantResult:
        metrics = Metrics()
        if mapper is None:
            mapper = self._make_mapper()
        if self.ranks > 1:
            batches = mapper.select(batches)
        batches = prefetch(device_put_batches(batches, self.device), depth=4)
        self._fld_est = None
        if self.cfg.em.estimate_fld and self.index.fld_tid is not None:
            # a restored checkpoint's estimator goes on where it stopped
            self._fld_est = mapper.fld
            batches = self._tee_fld(batches, mapper)
        with metrics.timer("map"), annotate("map"):
            result = mapper.run(batches, checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every)
        metrics.count("reads", result.total_reads)
        if result.collisions:
            metrics.count("fingerprint_collisions", result.collisions)
        log.info("mapped %d/%d reads (%d distinct signatures, %d overflow, "
                 "%d fingerprint collisions)", result.mapped,
                 result.total_reads, result.sigs.shape[0], result.overflow,
                 result.collisions)
        return self._infer(result, metrics, mapper, checkpoint_path)

    def _tee_fld(self, batches: Iterable[ReadBatch], mapper: Mapper):
        """Pass batches through while sampling the first paired ones into a
        fragment-length estimator (map/fld.py) that shares the mapper's
        device table; it goes inert after its sampling batches."""
        for b in batches:
            if b.codes2 is not None and self._fld_est is None:
                self._fld_est = mapper.make_fld_estimator()
            if self._fld_est is not None and self._fld_est.active:
                self._fld_est.feed(b)
            yield b

    def _fld_cfg(self, em_cfg: EMConfig, mapper
                 ) -> Tuple[EMConfig, Optional[Tuple]]:
        """Apply the estimated FLD (if any) to the effective-length model;
        on several ranks from their histograms summed (fault 5)."""
        if self.ranks > 1:
            est = None
            if em_cfg.estimate_fld and self.index.fld_tid is not None:
                est = estimate_from_hist(mapper.fld_histogram())
        else:
            est = None if self._fld_est is None else self._fld_est.estimate()
        if est is None:
            return em_cfg, None
        mean, sd, n = est
        log.info("estimated fragment-length distribution from %d mapped "
                 "pairs: mean %.1f, sd %.1f", n, mean, sd)
        return dataclasses.replace(
            em_cfg, mean_fragment_length=mean, fragment_length_sd=sd), est

    def _broadcast_snapshot(self, arr, it: int, conv: bool, shape):
        """Rank 0's stage snapshot (alpha or None, it, converged) on
        every rank: only rank 0 reads and writes snapshots, and every rank
        must take the same resume or skip decision."""
        if self.ranks == 1:
            return arr, it, conv
        meta = comm.broadcast_from0(np.asarray(
            [arr is not None, it, conv], np.int64))
        if not meta[0]:
            return None, 0, False
        payload = (np.asarray(arr, np.float64) if arr is not None
                   else np.zeros(shape, np.float64))
        return comm.broadcast_from0(payload), int(meta[1]), bool(meta[2])

    def _throttled_sync(self, path: str):
        """An ``on_sync`` that writes a snapshot to ``path`` at most once
        every ``SNAPSHOT_MIN_INTERVAL_S``."""
        last = [float("-inf")]

        def on_sync(a, it):
            now = time.monotonic()
            if now - last[0] < self.SNAPSHOT_MIN_INTERVAL_S:
                return
            last[0] = now
            save_em_snapshot(path, a, it)

        return on_sync

    def _em_snapshots(self, checkpoint_path: Optional[str], T: int):
        """The EM and bootstrap snapshots beside the map checkpoint, so one
        --checkpoint protects every stage. Returns (em_snap, boot_snap,
        alpha_init, it_init, em_converged, on_sync); em_converged marks the
        pin written after the EM stage, with which a resume skips EM (even
        one block from the converged alpha would move est_counts). A
        snapshot of another shape is ignored."""
        if not checkpoint_path:
            return None, None, None, 0, False, None
        em_snap = checkpoint_path + ".em.npz"
        boot_snap = checkpoint_path + ".boot.npz"
        alpha_init, it_init, em_converged = None, 0, False
        loaded = load_em_snapshot(em_snap) if comm.rank() == 0 else None
        if loaded is not None:
            a, it, conv = loaded
            if a.ndim == 1 and a.shape[0] == T:
                alpha_init, it_init, em_converged = a, it, conv
                log.info("resuming EM from snapshot at iteration %d%s", it,
                         " (converged: skipping EM)" if conv else "")
            else:
                log.warning("EM snapshot %s has shape %s != (%d,); "
                            "ignoring", em_snap, a.shape, T)
        alpha_init, it_init, em_converged = self._broadcast_snapshot(
            alpha_init, it_init, em_converged, (T,))
        on_sync = self._throttled_sync(em_snap) if comm.rank() == 0 else None
        return (em_snap, boot_snap, alpha_init, it_init, em_converged,
                on_sync)

    def _infer(self, result: MapResult, metrics: Metrics, mapper: Mapper,
               checkpoint_path: Optional[str] = None) -> QuantResult:
        with metrics.timer("resolve"), annotate("resolve"):
            member_lists, counts, dropped = resolve_signatures(result,
                                                               self.index)

        em_cfg, fld_est = self._fld_cfg(self.cfg.em, mapper)
        dtype = torch.float64 if em_cfg.use_x64 else torch.float32
        T = self.index.num_transcripts
        lengths = self.index.lengths
        ec = build_ec_table(member_lists, counts, T, dtype=dtype,
                            device=self.device)
        em_snap, boot_snap, alpha_init, it_init, em_converged, on_sync = \
            self._em_snapshots(checkpoint_path, T)
        em_skipped = alpha_init is not None and em_converged
        with metrics.timer("em"), annotate("em"):
            if em_skipped:
                alpha = torch.as_tensor(alpha_init, dtype=dtype,
                                        device=self.device)
                iters = it_init
            else:
                alpha, iters = run_em(ec, lengths, em_cfg,
                                      alpha_init=alpha_init, it_init=it_init,
                                      on_sync=on_sync)
            tpm = tpm_from_alpha(alpha, lengths, em_cfg)
            eff = effective_lengths(lengths, em_cfg, dtype, self.device)
            ll = float(log_likelihood(ec, alpha, eff))
        em_capped = iters >= em_cfg.max_iters
        if not em_skipped:
            metrics.count("em_iterations", iters)
            if em_capped:
                log.warning("EM stopped at max_iters=%d without meeting "
                            "rel_tol=%g", em_cfg.max_iters, em_cfg.rel_tol)
            if em_snap is not None and comm.rank() == 0:
                # pin the EM stage's end, unthrottled, so a crash in the
                # bootstrap resumes with EM skipped; a stage capped by
                # max_iters pins converged=False, so a resume under a
                # raised budget goes on iterating
                save_em_snapshot(em_snap, alpha, iters,
                                 converged=not em_capped)
        boot = None
        if em_cfg.bootstrap_samples > 0:
            B = em_cfg.bootstrap_samples
            b_init, b_it, b_sync = None, 0, None
            if boot_snap is not None:
                loaded = (load_em_snapshot(boot_snap) if comm.rank() == 0
                          else None)
                if loaded is not None and loaded[0].shape == (T, B):
                    b_init, b_it, _ = loaded
                    log.info("resuming bootstrap EM from snapshot at "
                             "iteration %d", b_it)
                b_init, b_it, _ = self._broadcast_snapshot(b_init, b_it,
                                                           False, (T, B))
                if comm.rank() == 0:
                    b_sync = self._throttled_sync(boot_snap)
            with metrics.timer("bootstrap"), annotate("bootstrap"):
                if self.ranks > 1 and B % self.ranks == 0:
                    boot_alpha, boot_iters = run_bootstrap_sharded(
                        ec, lengths, em_cfg, alpha_init=b_init,
                        it_init=b_it, on_sync=b_sync)
                else:
                    boot_alpha, boot_iters = run_bootstrap(
                        ec, lengths, em_cfg, alpha_init=b_init,
                        it_init=b_it, on_sync=b_sync)
                boot = boot_alpha.cpu().numpy()
            metrics.count("bootstrap_iterations", boot_iters)
            log.info("bootstrap: %d replicates in %.2fs", B,
                     metrics.timings["bootstrap"])
        for p in (em_snap, boot_snap):
            # the run is complete: a later fresh run must not warm-start
            # from these
            if p and comm.rank() == 0 and os.path.exists(p):
                os.remove(p)
        timings = metrics.snapshot()
        metrics.log_summary()
        return QuantResult(
            est_counts=alpha.cpu().numpy(),
            tpm=tpm.cpu().numpy(),
            eff_length=eff.cpu().numpy(),
            names=self.index.names,
            lengths=lengths,
            total_reads=result.total_reads,
            mapped=result.mapped - dropped,
            unmapped=result.unmapped + dropped,
            em_iterations=int(iters),
            bootstrap_counts=boot,
            timings=timings,
            fld_mean=None if fld_est is None else fld_est[0],
            fld_sd=None if fld_est is None else fld_est[1],
            fld_samples=None if fld_est is None else fld_est[2],
            log_likelihood=ll,
        )
