"""Quantifier: the end-to-end pipeline (index -> pseudoalignment -> EM ->
abundance table) on one device; counterpart of
``seekmer_tpu/models/quantifier.py``, single-device path only.

Not ported yet, and refused with an error naming its ROADMAP.md item
rather than skipped: meshes and sharding, the bootstrap, checkpoints, the
pack cache and fragment-length estimation from paired reads.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from seekmer_tpu.config import PipelineConfig
from seekmer_tpu.index.store import KMerIndex
from seekmer_tpu.io.fastq import (
    ReadBatch,
    batch_read_pairs_native,
    batch_reads_native,
)
from seekmer_tpu.utils.metrics import Metrics

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
    timings: Optional[Dict[str, float]] = None
    log_likelihood: Optional[float] = None


def check_pipeline_config(cfg: PipelineConfig) -> None:
    """Raise on pipeline features this port does not have yet."""
    if cfg.shard.data_axis != 1 or cfg.shard.index_axis != 1:
        raise NotImplementedError(
            "sharding is not ported yet: ROADMAP.md, still to port, "
            "'Multi-GPU'")
    if cfg.em.bootstrap_samples > 0:
        raise NotImplementedError(
            "the bootstrap is not ported yet: ROADMAP.md, still to port, "
            "'Bootstrap'")


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

    def _refuse_fld(self, batches: Iterable[ReadBatch]):
        """Paired reads against an index with the FLD payload would have
        their fragment-length distribution estimated (map/fld.py); that is
        not ported, so such a run must set the fragment length itself."""
        needs = self.cfg.em.estimate_fld and self.index.fld_tid is not None
        for b in batches:
            if needs and b.codes2 is not None:
                raise NotImplementedError(
                    "fragment-length estimation from paired reads is not "
                    "ported yet (ROADMAP.md, still to port, 'FLD "
                    "estimation'): give the fragment length (EMConfig."
                    "estimate_fld=False, --fragment-length)")
            yield b

    def quantify_batches(self, batches: Iterable[ReadBatch],
                         mapper: Optional[Mapper] = None) -> QuantResult:
        metrics = Metrics()
        if mapper is None:
            mapper = Mapper(self.index, self.cfg.map, device=self.device)
        batches = prefetch(device_put_batches(self._refuse_fld(batches),
                                              self.device), depth=4)
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

    def _infer(self, result: MapResult, metrics: Metrics) -> QuantResult:
        t0 = time.perf_counter()
        member_lists, counts, dropped = resolve_signatures(result, self.index)
        t_resolve = time.perf_counter() - t0

        em_cfg = self.cfg.em
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
            timings=timings,
            log_likelihood=ll,
        )
