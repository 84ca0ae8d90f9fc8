"""Quantifier: the end-to-end pipeline (index -> pseudoalignment -> EM ->
abundance table, with fragment-length estimation from paired reads and
bootstrap replicates) on one device; counterpart of
``seekmer_tpu/models/quantifier.py``, single-device path only.

Not ported yet, and refused with an error naming its ROADMAP.md item
rather than skipped: meshes and sharding. Checkpoints and the pack cache
have no entry here yet (the CLI refuses their flags).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from seekmer_tpu.config import EMConfig, PipelineConfig
from seekmer_tpu.index.store import KMerIndex
from seekmer_tpu.io.fastq import (
    ReadBatch,
    batch_read_pairs_native,
    batch_reads_native,
)
from seekmer_tpu.utils.metrics import Metrics

from ..em.bootstrap import run_bootstrap
from ..em.em import (
    build_ec_table,
    effective_lengths,
    log_likelihood,
    run_em,
    tpm_from_alpha,
)
from ..map.driver import Mapper, MapResult, check_device, resolve_signatures
from ..utils.prefetch import device_put_batches, prefetch

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


def check_pipeline_config(cfg: PipelineConfig) -> None:
    """Raise on pipeline features this port does not have yet."""
    if cfg.shard.data_axis != 1 or cfg.shard.index_axis != 1:
        raise NotImplementedError(
            "sharding is not ported yet: ROADMAP.md, still to port, "
            "'Multi-GPU'")


class Quantifier:
    def __init__(self, index: KMerIndex,
                 cfg: PipelineConfig = PipelineConfig(), device="cuda"):
        check_pipeline_config(cfg)
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg

    def quantify_files(self, fastq_paths: List[str],
                       mate_paths: Optional[List[str]] = None
                       ) -> QuantResult:
        """Quantify FASTQ(.gz) files through the C ingest."""
        if mate_paths:
            batches = batch_read_pairs_native(fastq_paths, mate_paths,
                                              self.cfg.map)
        else:
            batches = batch_reads_native(fastq_paths, self.cfg.map)
        return self.quantify_batches(batches)

    def quantify_batches(self, batches: Iterable[ReadBatch],
                         mapper: Optional[Mapper] = None) -> QuantResult:
        metrics = Metrics()
        if mapper is None:
            mapper = Mapper(self.index, self.cfg.map, device=self.device)
        batches = prefetch(device_put_batches(batches, self.device), depth=4)
        self._fld_est = None
        if self.cfg.em.estimate_fld and self.index.fld_tid is not None:
            batches = self._tee_fld(batches, mapper)
        with metrics.timer("map"):
            result = mapper.run(batches)
        metrics.count("reads", result.total_reads)
        if result.collisions:
            metrics.count("fingerprint_collisions", result.collisions)
        log.info("mapped %d/%d reads (%d distinct signatures, %d overflow, "
                 "%d fingerprint collisions)", result.mapped,
                 result.total_reads, result.sigs.shape[0], result.overflow,
                 result.collisions)
        return self._infer(result, metrics)

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

    def _fld_cfg(self, em_cfg: EMConfig) -> Tuple[EMConfig, Optional[Tuple]]:
        """Apply the estimated FLD (if any) to the effective-length model."""
        est = None if self._fld_est is None else self._fld_est.estimate()
        if est is None:
            return em_cfg, None
        mean, sd, n = est
        log.info("estimated fragment-length distribution from %d mapped "
                 "pairs: mean %.1f, sd %.1f", n, mean, sd)
        return dataclasses.replace(
            em_cfg, mean_fragment_length=mean, fragment_length_sd=sd), est

    def _infer(self, result: MapResult, metrics: Metrics) -> QuantResult:
        t0 = time.perf_counter()
        member_lists, counts, dropped = resolve_signatures(result, self.index)
        t_resolve = time.perf_counter() - t0

        em_cfg, fld_est = self._fld_cfg(self.cfg.em)
        dtype = torch.float64 if em_cfg.use_x64 else torch.float32
        T = self.index.num_transcripts
        lengths = self.index.lengths
        ec = build_ec_table(member_lists, counts, T, dtype=dtype,
                            device=self.device)
        with metrics.timer("em"):
            alpha, iters = run_em(ec, lengths, em_cfg)
            tpm = tpm_from_alpha(alpha, lengths, em_cfg)
            eff = effective_lengths(lengths, em_cfg, dtype, self.device)
            ll = float(log_likelihood(ec, alpha, eff))
        metrics.count("em_iterations", iters)
        if iters >= em_cfg.max_iters:
            log.warning("EM stopped at max_iters=%d without meeting "
                        "rel_tol=%g", em_cfg.max_iters, em_cfg.rel_tol)
        boot = None
        if em_cfg.bootstrap_samples > 0:
            with metrics.timer("bootstrap"):
                boot_alpha, boot_iters = run_bootstrap(ec, lengths, em_cfg)
                boot = boot_alpha.cpu().numpy()
            metrics.count("bootstrap_iterations", boot_iters)
            log.info("bootstrap: %d replicates in %.2fs",
                     em_cfg.bootstrap_samples, metrics.timings["bootstrap"])
        timings = {"resolve_s": t_resolve, **metrics.snapshot()}
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
