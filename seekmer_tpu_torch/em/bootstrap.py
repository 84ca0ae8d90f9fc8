"""Bootstrap uncertainty: multinomially resampled EC counts, EM re-run per
replicate; counterpart of ``seekmer_tpu/em/bootstrap.py``, single device.

All B replicates share one fixed point that iterates until every replicate
meets the shared convergence rule. ``run_bootstrap`` draws one resample and
then takes the route of the JAX package for the system (``em.use_dense``):
the dense fixed point over the membership matrix (K4 on a card) when it
fits, else the batched CSR EM here, replicate-minor (T, B) (A3 on a card).

What has no counterpart: the chunked execution (``_batched_em_chunked``,
``_use_chunked``), which worked around a TPU limit on execution time. The
snapshot arguments (``alpha_init``, ``it_init``, ``on_sync``) wait for the
checkpoint port (ROADMAP.md, still to port, "Checkpoints").
"""

from __future__ import annotations

import logging

import torch

from ..config import EMConfig
from .em import (
    ECTable,
    accel_schedule,
    csr_layout,
    dense_membership,
    effective_lengths,
    even_split,
    run_blocked_fixed_point,
    squarem_cycle,
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
               num_transcripts: int, cfg: EMConfig):
    """Batched CSR EM over resampled count rows cmat [B, E], in the dtype of
    ``cmat``. Returns (alpha [B, T], iterations). The iterate is (T, B),
    replicate-minor, the counts (E, B); the fixed point is
    ``ops/em_csr_cuda.em_fixed_point`` (one A3 launch on a card, the
    blocked loop over ``_batched_iter`` on the CPU). SQUAREM takes one
    steplength per replicate, an ``em_steps`` call a step."""
    from ..ops import em_csr_cuda

    dtype, device = cmat.dtype, cmat.device
    eff = effective_lengths(lengths, cfg, dtype, device)
    B, T = cmat.shape[0], num_transcripts
    layout = csr_layout(ec_ids, txp_ids, num_ecs, T)
    counts = cmat.t().contiguous()  # (E, B), loop-constant
    inv_eff = 1.0 / eff
    alpha0 = even_split(cmat.sum(dim=1), T)[None, :].expand(T, B).contiguous()
    if cfg.accel == "squarem":
        def em_iter(a):
            return em_csr_cuda.em_steps(a, counts, inv_eff, layout, 1,
                                        divide=False)[1]

        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg))
        return alpha.t(), it * 3
    alpha, it, _ = em_csr_cuda.em_fixed_point(alpha0, counts, inv_eff, layout,
                                              cfg, divide=False)
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


def run_bootstrap(ec: ECTable, lengths, cfg: EMConfig):
    """``cfg.bootstrap_samples`` replicates; returns (est_counts [B, T]
    float32, iterations). One resample, seeded by ``cfg.bootstrap_seed``
    on the table's device, feeds either route. The dense route runs plain
    EM whatever ``cfg.accel`` says, as the JAX kernel does."""
    from ..ops import em_cuda

    B, T = cfg.bootstrap_samples, ec.num_transcripts
    device = ec.counts.device
    counts = ec.counts.to(torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.bootstrap_seed)
    cmat = resample_counts(counts, B, gen)  # [B, E]
    if use_dense(ec, cfg, replicates=B):
        inv_eff = 1.0 / effective_lengths(lengths, cfg, torch.float32, device)
        alpha0 = (cmat.sum(dim=1, keepdim=True) / T).expand(B, T).contiguous()
        alpha, it = em_cuda.em_fixed_point(dense_membership(ec), cmat,
                                           inv_eff, alpha0, cfg)
        route = "dense"
    else:
        alpha, it = batched_em(cmat, ec.ec_ids, ec.txp_ids, lengths,
                               ec.num_ecs, T, cfg)
        route = "batched CSR"
    log.info("bootstrap EM: %d replicates, %s route, %d iterations", B,
             route, it)
    return alpha, it
