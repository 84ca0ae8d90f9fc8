"""EM transcript-abundance inference on torch tensors; counterpart of
``seekmer_tpu/em/em.py``.

The EC membership is a flat CSR (``txp_ids[nnz]`` / ``ec_ids[nnz]``, sorted
by EC), so one iteration is two segment sums (``index_add_``) and
elementwise work:

  E: w = alpha[txp] / eff[txp];  denom_c = segsum_ec(w)
     r = n_c * w / denom_c
  M: alpha'_t = segsum_txp(r)

The fixed point runs in blocks of ``check_every`` steps with one host read
of the converged flag per block, the schedule of the JAX package and of the
float64 oracle, so iteration counts match. ``EMConfig.backend="pallas"``
runs the dense fixed point instead (``use_dense``): K4 on a card, its plain
version on the CPU. The JAX chunked execution
(``_use_chunked``/``_chunked_fixed_point``) worked around a TPU limit on
execution time and has no counterpart. On CUDA, ``index_add_`` adds with
float atomics in no fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import EMConfig


class ECTable(NamedTuple):
    """Flat equivalence-class structure for EM."""

    counts: torch.Tensor  # float[E] reads per EC
    ec_ids: torch.Tensor  # int64[nnz] EC id per membership entry (sorted)
    txp_ids: torch.Tensor  # int64[nnz] transcript id per membership entry
    num_ecs: int
    num_transcripts: int


def build_ec_table(member_lists: List[np.ndarray], counts: np.ndarray,
                   num_transcripts: int, dtype=torch.float32,
                   device="cuda") -> ECTable:
    """Flatten per-EC member lists into the CSR on ``device`` (the card
    unless the caller names the CPU, as every entry point of the port)."""
    E = len(member_lists)
    ec_ids = np.repeat(np.arange(E, dtype=np.int64),
                       [m.size for m in member_lists])
    txp_ids = (np.concatenate(member_lists).astype(np.int64)
               if member_lists else np.empty(0, np.int64))
    return ECTable(
        counts=torch.tensor(np.asarray(counts, dtype=np.float64),
                            dtype=dtype, device=device),
        ec_ids=torch.from_numpy(ec_ids).to(device),
        txp_ids=torch.from_numpy(txp_ids).to(device),
        num_ecs=E,
        num_transcripts=num_transcripts,
    )


def effective_lengths(lengths, cfg: EMConfig, dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """Effective transcript lengths: ``max(len - mean + 1, 1)`` when
    ``fragment_length_sd`` is 0, else the truncated-normal expectation
    ``E_f[len - f + 1 | f <= len]`` over f in [1, mean + 5 sd]."""
    lengths = torch.as_tensor(lengths, device=device)
    l = lengths.to(dtype)
    mu = cfg.mean_fragment_length
    if cfg.fragment_length_sd <= 0.0:
        return torch.clamp(l - mu + 1.0, min=1.0)
    sd = cfg.fragment_length_sd
    F = int(np.ceil(cfg.mean_fragment_length + 5.0 * sd))
    f = torch.arange(1, F + 1, dtype=dtype, device=device)
    pdf = torch.exp(-0.5 * ((f - mu) / sd) ** 2)
    c0 = torch.cumsum(pdf, 0)
    c1 = torch.cumsum(pdf * f, 0)
    idx = torch.clamp(lengths.to(torch.int64), 1, F) - 1
    return torch.clamp((l + 1.0) - c1[idx] / c0[idx], min=1.0)


def em_step(alpha, ec: ECTable, eff):
    """One E+M iteration in counts space."""
    w = alpha[ec.txp_ids] / eff[ec.txp_ids]
    denom = torch.zeros(ec.num_ecs, dtype=w.dtype, device=w.device)
    denom.index_add_(0, ec.ec_ids, w)
    d = denom[ec.ec_ids]
    r = torch.where(d > 0, ec.counts[ec.ec_ids] * w / d, 0.0)
    out = torch.zeros(ec.num_transcripts, dtype=w.dtype, device=w.device)
    return out.index_add_(0, ec.txp_ids, r)


def squarem_cycle(em_iter, alpha, eps=1e-30, step_cap=64.0):
    """One SQUAREM (S3) cycle: two EM steps give the secant pair, a
    steplength ``-clip(|r|/|v|, 1, step_cap)`` extrapolates, clamped at 0,
    and a third EM step stabilizes. Same fixed points as plain EM. Works on
    (T,) single runs and (T, B) replicate-major batches, with one
    steplength per replicate."""
    a1 = em_iter(alpha)
    a2 = em_iter(a1)
    r = a1 - alpha
    v = (a2 - a1) - r
    dims = (0,) if alpha.ndim == 2 else ()
    rn = torch.sqrt(torch.sum(r * r, dim=dims))
    vn = torch.sqrt(torch.sum(v * v, dim=dims))
    step = -torch.clamp(rn / torch.clamp(vn, min=eps), 1.0, step_cap)
    ext = torch.clamp(alpha - 2.0 * step * r + (step * step) * v, min=0.0)
    ext = torch.where(torch.isfinite(ext), ext, a2)
    return em_iter(ext)


def accel_schedule(cfg: EMConfig) -> EMConfig:
    """Rescale the blocked budget to SQUAREM cycles (3 EM steps each) so
    max_iters/min_iters keep EM-step units."""
    return dataclasses.replace(
        cfg,
        max_iters=-(-cfg.max_iters // 3),
        min_iters=-(-cfg.min_iters // 3),
        check_every=max(cfg.check_every // 3, 1),
    )


def convergence_check(alpha_m, alpha_new, cfg: EMConfig) -> torch.Tensor:
    """Max relative change over active transcripts < rel_tol (a 0-d bool
    tensor); requires at least one active transcript."""
    active = alpha_new > cfg.count_floor
    rel = torch.abs(alpha_new - alpha_m) / (alpha_new + cfg.abs_floor)
    return active.any() & (torch.where(active, rel, 0.0).max() < cfg.rel_tol)


def run_blocked_fixed_point(em_iter, alpha0, cfg: EMConfig,
                            it_init: int = 0):
    """Iterate ``alpha -> em_iter(alpha)`` in blocks of check_every - 1 raw
    steps plus one monitored step, testing convergence between the block's
    last two iterates with one host read per block. Returns
    (it, converged, alpha); ``it`` counts from ``it_init``."""
    C = max(cfg.check_every, 1)
    it, converged, alpha = it_init, False, alpha0
    while not converged and it < cfg.max_iters:
        for _ in range(C - 1):
            alpha = em_iter(alpha)
        alpha_new = em_iter(alpha)
        converged = (it + C >= cfg.min_iters
                     and bool(convergence_check(alpha, alpha_new, cfg)))
        alpha = alpha_new
        it += C
    return it, converged, alpha


def dense_membership(ec: ECTable) -> torch.Tensor:
    """Dense EC-membership matrix float32[E, T] from the flat CSR."""
    M = torch.zeros((ec.num_ecs, ec.num_transcripts), dtype=torch.float32,
                    device=ec.counts.device)
    M[ec.ec_ids, ec.txp_ids] = 1.0
    return M


def use_dense(ec: ECTable, cfg: EMConfig, replicates: int = 1) -> bool:
    """Whether EM runs the dense fixed point (K4) rather than the CSR form:
    the rule of the JAX ``_use_pallas``. x64 and ``backend="csr"`` take the
    CSR form, as does ``auto`` for a single run; otherwise the dense route
    when the system fits ``fits_dense``, and ``backend="pallas"`` on a
    system that does not fit raises."""
    from ..ops.em_dense import fits_dense

    if cfg.use_x64 or cfg.backend == "csr":
        return False
    if cfg.backend == "auto" and replicates == 1:
        return False
    ok = fits_dense(ec.num_ecs, ec.num_transcripts, replicates)
    if cfg.backend == "pallas" and not ok:
        raise ValueError("system too large for the dense EM kernel (K4): "
                         f"{ec.num_ecs} ECs x {ec.num_transcripts} "
                         f"transcripts x {replicates} replicates")
    return ok


def run_em(ec: ECTable, lengths, cfg: EMConfig = EMConfig(),
           alpha_init=None, it_init: int = 0) -> Tuple[torch.Tensor, int]:
    """EM to convergence. Returns (alpha float[T], iterations).
    ``alpha_init``/``it_init`` warm-start the fixed point; max_iters counts
    the total across restarts. A fresh run under ``backend="pallas"``
    takes the dense fixed point (K4 with R = 1, float32); a resumed one
    (``it_init`` > 0) stays on the CSR form, whose budget counts from
    ``it_init``."""
    dtype, device = ec.counts.dtype, ec.counts.device
    T = ec.num_transcripts
    if it_init == 0 and use_dense(ec, cfg):
        from ..ops import em_cuda

        f32 = torch.float32
        inv_eff = 1.0 / effective_lengths(lengths, cfg, f32, device)
        if alpha_init is None:
            alpha0 = (ec.counts.sum() / T).to(f32).repeat(1, T)
        else:
            alpha0 = torch.as_tensor(np.asarray(alpha_init), dtype=f32,
                                     device=device).reshape(1, T)
        alpha, iters = em_cuda.em_fixed_point(
            dense_membership(ec), ec.counts.to(f32).reshape(1, -1), inv_eff,
            alpha0, cfg)
        return alpha[0], iters
    eff = effective_lengths(lengths, cfg, dtype, device)
    if alpha_init is None:
        alpha0 = (ec.counts.sum() / T).repeat(T)
    else:
        alpha0 = torch.as_tensor(np.asarray(alpha_init), dtype=dtype,
                                 device=device)

    def em_iter(a):
        return em_step(a, ec, eff)

    if cfg.accel == "squarem":
        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg),
            it_init=it_init // 3)
        return alpha, it * 3
    it, _, alpha = run_blocked_fixed_point(em_iter, alpha0, cfg,
                                           it_init=it_init)
    return alpha, it


def log_likelihood(ec: ECTable, alpha, eff) -> torch.Tensor:
    """L = sum_c n_c log(sum_{t in c} theta_t / eff_t), theta = alpha
    normalized; ECs with no mass contribute 0."""
    theta = alpha / torch.clamp(alpha.sum(), min=1e-300)
    w = theta[ec.txp_ids] / eff[ec.txp_ids]
    denom = torch.zeros(ec.num_ecs, dtype=w.dtype, device=w.device)
    denom.index_add_(0, ec.ec_ids, w)
    return torch.where((ec.counts > 0) & (denom > 0),
                       ec.counts * torch.log(torch.clamp(denom, min=1e-300)),
                       0.0).sum()


def tpm_from_alpha(alpha, lengths, cfg: EMConfig):
    eff = effective_lengths(lengths, cfg, alpha.dtype, alpha.device)
    rate = torch.where(alpha > 0, alpha / eff, 0.0)
    s = rate.sum()
    return torch.where(s > 0, 1e6 * rate / s, 0.0)
