"""Bootstrap uncertainty: multinomially resampled EC counts, EM re-run per
replicate; counterpart of ``seekmer_tpu/em/bootstrap.py``, single device.

All B replicates share one fixed point that iterates until every replicate
meets the shared convergence rule. ``run_bootstrap`` draws one resample and
then takes the route of the JAX package for the system (``em.use_dense``):
the dense fixed point over the membership matrix (K4 on a card) when it
fits, else the batched CSR EM here, replicate-minor (T, B) (A3 on a card).

Snapshots: ``run_bootstrap(..., alpha_init, it_init, on_sync)`` resumes
the batched fixed point from a (T, B) iterate and calls ``on_sync`` between
its pieces (``em.csr_fixed_point``), as the JAX ``_batched_em_chunked``
does at its syncs. The resample is seeded by ``EMConfig.bootstrap_seed``,
so a resumed run draws the same count matrix and replays the same
iterates. A resumed or snapshotted run takes the batched CSR route; the
dense route serves fresh runs only, as in the JAX package. The JAX
package's automatic chunking (``_use_chunked``) worked around a TPU limit
on execution time and has no counterpart.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from ..config import EMConfig
from ..utils.metrics import Metrics
from .em import (
    ECTable,
    accel_schedule,
    csr_fixed_point,
    csr_layout,
    dense_membership,
    effective_lengths,
    even_split,
    run_blocked_fixed_point,
    squarem_cycle,
    squarem_hook,
    use_dense,
)

log = logging.getLogger(__name__)


def resample_counts(counts: torch.Tensor, num_samples: int,
                    generator: torch.Generator) -> torch.Tensor:
    """``num_samples`` multinomial resamples of the EC count vector,
    n^(b) ~ Mult(N, n / N) with N = sum(n): [num_samples, E] in the dtype
    of ``counts``. Replicates are drawn one at a time (N category draws,
    then a bincount), so memory stays O(N + E), not O(B N). ``generator``
    must live on the device of ``counts``. JAX's
    ``jax.random.multinomial`` bits cannot be reproduced here: the two
    packages agree in distribution only."""
    E = counts.shape[0]
    N = int(round(float(counts.sum())))
    out = torch.zeros((num_samples, E), dtype=counts.dtype,
                      device=counts.device)
    if N == 0 or E == 0:
        return out
    p = counts.to(torch.float64)
    for b in range(num_samples):
        draw = torch.multinomial(p, N, replacement=True, generator=generator)
        out[b] = torch.bincount(draw, minlength=E).to(counts.dtype)
    return out


def batched_em(cmat: torch.Tensor, ec_ids, txp_ids, lengths, num_ecs: int,
               num_transcripts: int, cfg: EMConfig, alpha_init=None,
               it_init: int = 0, on_sync: Optional[Callable] = None,
               check: Optional[Callable] = None):
    """Batched CSR EM over resampled count rows cmat [B, E], in the dtype of
    ``cmat``. Returns (alpha [B, T], iterations). The iterate is (T, B),
    replicate-minor, the counts (E, B); the fixed point is
    ``ops/em_csr_cuda.em_fixed_point`` (one A3 launch on a card, the
    blocked loop over ``_batched_iter`` on the CPU). SQUAREM takes one
    steplength per replicate, an ``em_steps`` call a step.
    ``alpha_init`` (T, B) and ``it_init`` resume from a snapshot;
    ``on_sync(alpha_TB_np, it)`` is the snapshot hook (``em.run_em``).
    ``check(alpha, alpha_new)`` replaces the convergence test
    (``run_blocked_fixed_point``; the sharded bootstrap's test across
    ranks): the fixed point then runs a block a launch of ``em_steps``,
    and ``on_sync`` gets the (T, B) tensor at each block end."""
    from ..ops import em_csr_cuda

    dtype, device = cmat.dtype, cmat.device
    eff = effective_lengths(lengths, cfg, dtype, device)
    B, T = cmat.shape[0], num_transcripts
    layout = csr_layout(ec_ids, txp_ids, num_ecs, T)
    counts = cmat.t().contiguous()  # (E, B), loop-constant
    inv_eff = 1.0 / eff
    if alpha_init is None:
        alpha0 = even_split(cmat.sum(dim=1), T)[None, :].expand(
            T, B).contiguous()
    else:
        alpha0 = torch.as_tensor(np.asarray(alpha_init), dtype=dtype,
                                 device=device).reshape(T, B).contiguous()
    if cfg.accel == "squarem":
        def em_iter(a):
            return em_csr_cuda.em_steps(a, counts, inv_eff, layout, 1,
                                        divide=False)[1]

        hook = (squarem_hook(on_sync) if check is None or on_sync is None
                else lambda a, it: on_sync(a, it * 3))
        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg),
            it_init=it_init // 3, on_sync=hook, check=check)
        return alpha.t(), it * 3
    if check is not None:
        it, _, alpha = run_blocked_fixed_point(
            None, alpha0, cfg, it_init=it_init, on_sync=on_sync, check=check,
            em_block=lambda a, steps: em_csr_cuda.em_steps(
                a, counts, inv_eff, layout, steps, divide=False))
        return alpha.t(), it
    alpha, it, _ = csr_fixed_point(alpha0, counts, inv_eff, layout, cfg,
                                   divide=False, it_init=it_init,
                                   on_sync=on_sync)
    return alpha.t(), it


def _batched_iter(counts_nnz, inv_eff_nnz, ec_ids, txp_ids,
                  num_ecs: int, num_transcripts: int):
    """One batched E+M step over (nnz, B) gathers and ``index_add_``, the
    replicate axis minor: A3's plain version."""
    def em_iter(alpha):  # (T, B)
        w = alpha[txp_ids] * inv_eff_nnz
        denom = torch.zeros((num_ecs, w.shape[1]), dtype=w.dtype,
                            device=w.device).index_add_(0, ec_ids, w)
        d = denom[ec_ids]
        r = torch.where(d > 0, counts_nnz * w / d, 0.0)
        return torch.zeros((num_transcripts, w.shape[1]), dtype=w.dtype,
                           device=w.device).index_add_(0, txp_ids, r)
    return em_iter


def run_bootstrap(ec: ECTable, lengths, cfg: EMConfig, alpha_init=None,
                  it_init: int = 0, on_sync: Optional[Callable] = None,
                  metrics: Optional[Metrics] = None):
    """``cfg.bootstrap_samples`` replicates; returns (est_counts [B, T]
    float32, iterations). One resample, seeded by ``cfg.bootstrap_seed``
    on the table's device, feeds either route; it is the span
    ``resample`` of ``metrics``. The dense route runs plain
    EM whatever ``cfg.accel`` says, as the JAX kernel does, and serves
    fresh runs only: ``alpha_init`` ((T, B), replicate-major) or
    ``it_init`` take the batched CSR route, which ``on_sync`` snapshots
    (``batched_em``)."""
    from ..ops import em_cuda

    B, T = cfg.bootstrap_samples, ec.num_transcripts
    device = ec.counts.device
    counts = ec.counts.to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.bootstrap_seed)
    with (metrics if metrics is not None else Metrics()).span("resample"):
        cmat = resample_counts(counts, B, gen)  # [B, E]
    if alpha_init is None and it_init == 0 and use_dense(ec, cfg,
                                                        replicates=B):
        inv_eff = 1.0 / effective_lengths(lengths, cfg, torch.float32, device)
        alpha0 = (cmat.sum(dim=1, keepdim=True) / T).expand(B, T).contiguous()
        alpha, it = em_cuda.em_fixed_point(dense_membership(ec), cmat,
                                           inv_eff, alpha0, cfg)
        route = "dense"
    else:
        alpha, it = batched_em(cmat, ec.ec_ids, ec.txp_ids, lengths,
                               ec.num_ecs, T, cfg, alpha_init=alpha_init,
                               it_init=it_init, on_sync=on_sync)
        route = "batched CSR"
    log.info("bootstrap EM: %d replicates, %s route, %d iterations", B,
             route, it)
    return alpha, it
