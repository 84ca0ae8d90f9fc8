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
stage snapshots.

A call's stages are spans (``utils/metrics.Metrics.span``): timers in
``QuantResult.timings`` (``run_info.json``) and named ranges in a
``--trace-dir`` trace, all inside the range ``quantify``, which encloses
the call (one ``Quantifier`` runs one call at a time, so that range groups
a sample's ranges, the prefetch thread's too). In order: ``mapper`` (on a
card the raw index uploaded, ``index_upload``, then laid out in place by
I1, ``index_layout``; on the CPU laid out on the host first), ``map``
(waits for the next batch, ``map_wait``; FLD sampling, ``fld``; the
table's read-back and merge, ``finalize`` with ``readback`` and
``merge``), ``resolve`` (its intersections of the multi-EC signatures,
I2 on a card, ``intersect``), ``ec_table`` (the FLD estimate, the EC table, the
snapshots' set-up), ``em``, ``bootstrap`` (its ``resample``) and
``collect`` (the results to the host); ``ingest``, ``upload`` and its
``pack`` on the prefetch thread. ``wall_s`` covers the whole call.
Counters split the unmapped fragments: ``complex_fragments`` (past
``max_ecs_per_read`` classes; counted where K3 runs with a counter, so
not in fast mode nor under the prefix-sharded index, which report none),
``empty_intersection_fragments`` (their classes' members intersect to
nothing) and the rest, no hit; ``intersect_members`` (the summed sizes
of every EC list of every multi-EC signature, the work ``intersect`` is
given) and ``multi_gene_classes`` (classes across genes) weigh the
cross-gene work; ``intersect_on_device`` is 1 where ``intersect`` ran I2.

Several ranks (``PipelineConfig.shard``): the mapper that
``parallel/mappers.make_mapper`` builds answers every rank question (its
share of the batches, the merged map result, the FLD estimate, the
agreed restore, rank 0's stage snapshots on every rank); every rank runs
the one-card EM on the merged table (the JAX package's nnz-sharded
collective EM has no counterpart: sharding it saves no memory, and an
exchange a block costs more than the block), and the bootstrap goes over
the ranks (``parallel/bootstrap_shard.bootstrap_on_ranks``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
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
from ..map.signature import SIG_PAD
from ..parallel.bootstrap_shard import bootstrap_on_ranks as run_bootstrap
from ..parallel.mappers import make_mapper
from ..utils.checkpoint import StageSnapshots
from ..utils.metrics import Metrics
from ..utils.prefetch import device_put_batches, prefetch
from ..utils.profiling import annotate

log = logging.getLogger(__name__)


def multi_gene_classes(member_lists: List[np.ndarray],
                       gene_of: Optional[np.ndarray]) -> int:
    """The classes whose members lie in more than one gene; ``gene_of``
    holds each transcript's gene as an int (0 classes without it)."""
    if gene_of is None or not member_lists:
        return 0
    lens = np.fromiter((m.size for m in member_lists), np.int64,
                       len(member_lists))
    starts = np.zeros(lens.size, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    g = gene_of[np.concatenate(member_lists)]
    return int((np.minimum.reduceat(g, starts)
                != np.maximum.reduceat(g, starts)).sum())


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
    def __init__(self, index: KMerIndex,
                 cfg: PipelineConfig = PipelineConfig(), device="cuda",
                 input_share: Optional[Tuple[int, int]] = None):
        """``input_share``: with several ranks, this rank's share of the
        files (``parallel/mappers.make_mapper``)."""
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg
        self.input_share = input_share
        # each transcript's gene as an int, for ``multi_gene_classes``
        self._gene_of = (None if index.genes is None else
                         np.unique(index.genes, return_inverse=True)[1])

    def _make_mapper(self, metrics: Metrics, pack_cache: bool = False
                     ) -> Mapper:
        """A mapper of the index on the device, built in the span
        ``mapper`` of ``metrics``."""
        with metrics.span("mapper"):
            return make_mapper(self.index, self.cfg, self.device,
                               self.input_share, metrics, pack_cache)

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
        metrics = Metrics()
        with annotate("quantify"):
            mapper = self._make_mapper(metrics, pack_cache is not None)
            if pack_cache is not None:
                return self._quantify_pack_cache(
                    fastq_paths, mate_paths, checkpoint_path,
                    checkpoint_every, pack_cache, mapper, metrics)
            if checkpoint_path:
                source = CheckpointableBatchSource(fastq_paths, mate_paths,
                                                   self.cfg.map)
                mapper.restore(checkpoint_path, source)
                batches = iter(source)
            else:
                batches = self._native_batches(fastq_paths, mate_paths)
            return self._quantify(batches, mapper, metrics, checkpoint_path,
                                  checkpoint_every)

    def _quantify_pack_cache(self, fastq_paths, mate_paths, checkpoint_path,
                             checkpoint_every, pack_cache, mapper,
                             metrics: Metrics) -> QuantResult:
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
                mapper.restore(checkpoint_path, source)
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
        return self._quantify(batches, mapper, metrics, checkpoint_path,
                              checkpoint_every)

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
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 50) -> QuantResult:
        """Quantify ``batches``."""
        metrics = Metrics()
        with annotate("quantify"):
            return self._quantify(batches, self._make_mapper(metrics),
                                  metrics, checkpoint_path, checkpoint_every)

    def _quantify(self, batches: Iterable[ReadBatch], mapper: Mapper,
                  metrics: Metrics, checkpoint_path: Optional[str],
                  checkpoint_every: int) -> QuantResult:
        """The stages after the mapper's build, timed into the call's
        ``metrics``."""
        batches = prefetch(device_put_batches(mapper.select(batches),
                                              self.device, metrics),
                           depth=4, metrics=metrics)
        with metrics.span("map"):
            result = mapper.run(batches, checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every)
        metrics.count("reads", result.total_reads)
        metrics.count("distinct_signatures", result.sigs.shape[0])
        if result.complex_reads is not None:
            metrics.count("complex_fragments", result.complex_reads)
        if result.collisions:
            metrics.count("fingerprint_collisions", result.collisions)
        log.info("mapped %d/%d reads (%d distinct signatures, %d overflow, "
                 "%d fingerprint collisions)", result.mapped,
                 result.total_reads, result.sigs.shape[0], result.overflow,
                 result.collisions)
        return self._infer(result, metrics, mapper, checkpoint_path)

    def _infer(self, result: MapResult, metrics: Metrics, mapper: Mapper,
               checkpoint_path: Optional[str] = None) -> QuantResult:
        # called as (result, index), the form gpubench's faults wrap
        with metrics.span("resolve"), metrics.active():
            member_lists, counts, dropped = resolve_signatures(result,
                                                               self.index)
        metrics.count("empty_intersection_fragments", dropped)

        em_cfg = self.cfg.em
        T, B = self.index.num_transcripts, em_cfg.bootstrap_samples
        lengths = self.index.lengths
        with metrics.span("ec_table"):
            # the signatures resolve_signatures intersects, of two or more
            # ECs: a row's EC ids are sorted, SIG_PAD after them
            sigs = result.sigs
            metrics.count("multi_ec_signatures", int(
                (sigs[:, 1] != SIG_PAD).sum()) if sigs.shape[1] > 1 else 0)
            fld_est = mapper.fld_estimate()
            if fld_est is not None:
                log.info("estimated fragment-length distribution from %d "
                         "mapped pairs: mean %.1f, sd %.1f", fld_est[2],
                         *fld_est[:2])
                em_cfg = dataclasses.replace(
                    em_cfg, mean_fragment_length=fld_est[0],
                    fragment_length_sd=fld_est[1])
            dtype = torch.float64 if em_cfg.use_x64 else torch.float32
            ec = build_ec_table(member_lists, counts, T, dtype=dtype,
                                device=self.device)
            metrics.count("classes", ec.num_ecs)
            metrics.count("nnz", ec.txp_ids.shape[0])
            metrics.count("multi_gene_classes",
                          multi_gene_classes(member_lists, self._gene_of))
            snaps = StageSnapshots(checkpoint_path, T, B, mapper.rank == 0,
                                   mapper.from_rank0)
            alpha_init, it_init, em_converged = snaps.load("EM")
        em_skipped = alpha_init is not None and em_converged
        with metrics.span("em"):
            if em_skipped:
                alpha = torch.as_tensor(alpha_init, dtype=dtype,
                                        device=self.device)
                iters = it_init
            else:
                alpha, iters = run_em(ec, lengths, em_cfg,
                                      alpha_init=alpha_init, it_init=it_init,
                                      on_sync=snaps.on_sync("EM"))
            tpm = tpm_from_alpha(alpha, lengths, em_cfg)
            eff = effective_lengths(lengths, em_cfg, dtype, self.device)
            ll = float(log_likelihood(ec, alpha, eff))
        if not em_skipped:
            em_capped = iters >= em_cfg.max_iters
            metrics.count("em_iterations", iters)
            if em_capped:
                log.warning("EM stopped at max_iters=%d without meeting "
                            "rel_tol=%g", em_cfg.max_iters, em_cfg.rel_tol)
            snaps.pin(alpha, iters, converged=not em_capped)
        boot = None
        if B > 0:  # ``run_bootstrap``: the name gpubench's faults patch
            b_init, b_it, _ = snaps.load("bootstrap")
            with metrics.span("bootstrap"):
                boot_alpha, boot_iters = run_bootstrap(
                    ec, lengths, em_cfg, ranks=mapper.n_ranks,
                    alpha_init=b_init, it_init=b_it,
                    on_sync=snaps.on_sync("bootstrap"), metrics=metrics)
                boot = boot_alpha.cpu().numpy()
            metrics.count("bootstrap_iterations", boot_iters)
            log.info("bootstrap: %d replicates in %.2fs", B,
                     metrics.timings["bootstrap"])
        snaps.done()
        with metrics.span("collect"):
            est_counts, tpm, eff = (t.cpu().numpy() for t in (alpha, tpm,
                                                              eff))
        timings = metrics.snapshot()
        metrics.log_summary()
        return QuantResult(
            est_counts=est_counts,
            tpm=tpm,
            eff_length=eff,
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
