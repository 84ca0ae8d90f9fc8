"""EM transcript-abundance inference on torch tensors; counterpart of
``seekmer_tpu/em/em.py``.

The EC membership is a flat CSR (``txp_ids[nnz]`` / ``ec_ids[nnz]``, sorted
by EC), so one iteration is two segment sums (``index_add_``) and
elementwise work:

  E: w = alpha[txp] / eff[txp];  denom_c = segsum_ec(w)
     r = n_c * w / denom_c
  M: alpha'_t = segsum_txp(r)

The fixed point runs in blocks of ``check_every`` steps, testing
convergence between each block's last two iterates, the schedule of the
JAX package and of the float64 oracle, so iteration counts match. On the
card the whole fixed point is one launch of A3 (``csrc/em_csr.cu``,
``ops/em_csr_cuda.em_fixed_point``) over the table's ``csr_layout`` cut
into tiles of whole connected components; it adds in the order the CPU's
``index_add_`` does, so it gives the CPU's bits and iteration count. On
the CPU ``run_blocked_fixed_point`` drives the plain ``em_step``.
``EMConfig.backend="pallas"`` runs the dense fixed point instead
(``use_dense``): K4 on a card, its plain version on the CPU.

Snapshots: ``run_em(..., on_sync=f)`` calls ``f(alpha_np, it)`` between
pieces of the fixed point (``csr_fixed_point``), each piece A3's launch
with its budget capped a whole number of blocks past the last piece's end,
so the pieces replay the one launch's iterates and a resume from any
snapshot (``alpha_init``, ``it_init``) gives its bits. They are the
counterpart of the JAX ``_chunked_fixed_point``'s sync points, taken only
when a caller asks for snapshots: without ``on_sync`` the fixed point stays
one launch. The JAX package's automatic chunking of long runs
(``_use_chunked``, ``_MAX_EXEC_S``) worked around a TPU limit on execution
time and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

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


class CSRLayout(NamedTuple):
    """An EC table in the form A3 walks it: rows by EC (the CSR) for the
    E-phase, by transcript (the CSC) for the M-phase; int32 offsets and
    ids. ``ec_ids``/``txp_ids`` are the table's own, for the plain
    version. ``tilings`` caches A3's tilings of it
    (``em_csr_cuda.tiling``) by shape."""

    ec_ids: torch.Tensor  # int64[nnz], sorted
    txp_ids: torch.Tensor  # int64[nnz]
    ec_off: torch.Tensor  # int32[E+1] row offsets of each EC
    txp: torch.Tensor  # int32[nnz] member transcripts, in nnz order
    txp_off: torch.Tensor  # int32[T+1] offsets of each transcript's run
    csc_ec: torch.Tensor  # int32[nnz] EC of each entry, by transcript
    num_ecs: int
    num_transcripts: int
    tilings: dict


def csr_layout(ec_ids, txp_ids, num_ecs: int,
               num_transcripts: int) -> CSRLayout:
    """The CSR and CSC of a flat EC table (``ec_ids`` sorted), on its
    device; built once per fixed point. The CSC is the nnz stably sorted by
    transcript, which keeps each transcript's entries in nnz order, the
    order in which ``index_add_`` adds them on the CPU."""
    if max(ec_ids.numel(), num_ecs, num_transcripts) >= 2**31:
        raise ValueError("EC tables of 2^31 entries or more do not fit "
                         "A3's int32 offsets")
    if ec_ids.numel() > 1 and bool((ec_ids[1:] < ec_ids[:-1]).any()):
        raise ValueError("ec_ids must be sorted")

    def offsets(ids, n):
        off = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
        off[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
        return off.to(torch.int32)

    perm = torch.sort(txp_ids, stable=True).indices
    return CSRLayout(ec_ids, txp_ids, offsets(ec_ids, num_ecs),
                     txp_ids.to(torch.int32),
                     offsets(txp_ids, num_transcripts),
                     ec_ids[perm].to(torch.int32), num_ecs, num_transcripts,
                     {})


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


def even_split(total: torch.Tensor, T: int) -> torch.Tensor:
    """``total / T`` as one IEEE division on every device. PyTorch's CUDA
    division by a Python number multiplies by its reciprocal instead, one
    bit off for many values, and the card's fixed point would then start
    elsewhere than the CPU's; the CPU divides either way."""
    return total / torch.tensor(T, dtype=total.dtype, device=total.device)


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
                            it_init: int = 0, em_block=None, on_sync=None,
                            check=None):
    """Iterate ``alpha -> em_iter(alpha)`` in blocks of check_every - 1 raw
    steps plus one monitored step, testing convergence between the block's
    last two iterates with one host read per block: the plain version of
    A3's fixed point, and SQUAREM's loop. ``em_block(alpha, steps)``,
    where given, runs a whole block and returns its last two iterates.
    ``on_sync(alpha, it)``, where given, is called at every block end that
    does not finish the run. ``check(alpha, alpha_new)`` replaces
    ``convergence_check`` (the sharded bootstrap's test across ranks); it
    runs at every block end, ``min_iters`` or not, so that every rank joins
    its exchange. Returns (it, converged, alpha); ``it`` counts from
    ``it_init``."""
    C = max(cfg.check_every, 1)
    it, converged, alpha = it_init, False, alpha0
    while not converged and it < cfg.max_iters:
        if em_block is not None:
            alpha, alpha_new = em_block(alpha, C)
        else:
            for _ in range(C - 1):
                alpha = em_iter(alpha)
            alpha_new = em_iter(alpha)
        if check is None:
            converged = (it + C >= cfg.min_iters
                         and bool(convergence_check(alpha, alpha_new, cfg)))
        else:
            ok = check(alpha, alpha_new)
            converged = it + C >= cfg.min_iters and ok
        alpha = alpha_new
        it += C
        if on_sync is not None and not converged and it < cfg.max_iters:
            on_sync(alpha, it)
    return it, converged, alpha


SYNC_TARGET_S = 2.0  # seconds of fixed point between two snapshots


def csr_fixed_point(alpha0, counts, scale, layout, cfg: EMConfig,
                    divide: bool, it_init: int = 0,
                    on_sync: Optional[Callable] = None):
    """A3's fixed point (``em_csr_cuda.em_fixed_point``), one launch; with
    ``on_sync``, pieces of it with ``on_sync(alpha_np, it)`` between two.
    A piece runs from (it, alpha) under the budget ``min(max_iters, it +
    k * check_every)``, so it ends on a block boundary and the pieces
    replay the one launch's iterates; k starts at 1 and adapts so that a
    piece takes about ``SYNC_TARGET_S``, as the JAX
    ``_chunked_fixed_point`` does. Returns (alpha, it, converged)."""
    from ..ops import em_csr_cuda

    def piece(alpha, it, cap):
        return em_csr_cuda.em_fixed_point(
            alpha, counts, scale, layout,
            dataclasses.replace(cfg, max_iters=cap), divide=divide,
            it_init=it)

    if on_sync is None:
        return piece(alpha0, it_init, cfg.max_iters)
    C = max(cfg.check_every, 1)
    alpha, it, k = alpha0, it_init, 1
    while True:
        t0 = time.perf_counter()
        alpha, it, converged = piece(alpha, it,
                                     min(cfg.max_iters, it + k * C))
        dt = time.perf_counter() - t0
        if converged or it >= cfg.max_iters:
            return alpha, it, converged
        on_sync(alpha.cpu().numpy(), it)
        per_block = max(dt / k, 1e-4)
        remaining = max((cfg.max_iters - it) // C, 1)
        k = max(1, min(int(SYNC_TARGET_S / per_block), remaining))


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
           alpha_init=None, it_init: int = 0,
           on_sync: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """EM to convergence. Returns (alpha float[T], iterations).
    ``alpha_init``/``it_init`` warm-start the fixed point from a snapshot;
    max_iters counts the total across restarts. ``on_sync(alpha_np, it)``
    is the snapshot hook: the CSR fixed point then runs in pieces with a
    call between two, and SQUAREM calls it at its block ends (``it`` in EM
    steps, 3 a cycle). A fresh run under ``backend="pallas"`` takes the
    dense fixed point (K4 with R = 1, float32) and ignores ``on_sync``, as
    the JAX Pallas path does; a resumed one (``it_init`` > 0) stays on the
    CSR form (A3 on a card), whose budget counts from ``it_init``."""
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
    from ..ops import em_csr_cuda

    eff = effective_lengths(lengths, cfg, dtype, device)
    if alpha_init is None:
        alpha0 = even_split(ec.counts.sum(), T).repeat(T)
    else:
        alpha0 = torch.as_tensor(np.asarray(alpha_init), dtype=dtype,
                                 device=device)
    layout = csr_layout(ec.ec_ids, ec.txp_ids, ec.num_ecs, T)
    if cfg.accel == "squarem":
        def em_iter(a):
            return em_csr_cuda.em_steps(a, ec.counts, eff, layout, 1,
                                        divide=True)[1]

        it, _, alpha = run_blocked_fixed_point(
            lambda a: squarem_cycle(em_iter, a), alpha0, accel_schedule(cfg),
            it_init=it_init // 3, on_sync=squarem_hook(on_sync))
        return alpha, it * 3
    alpha, it, _ = csr_fixed_point(alpha0, ec.counts, eff, layout, cfg,
                                   divide=True, it_init=it_init,
                                   on_sync=on_sync)
    return alpha, it


def squarem_hook(on_sync: Optional[Callable]):
    """``on_sync`` for SQUAREM's block ends: the iterate to the host and
    the count in EM steps (a cycle is 3)."""
    if on_sync is None:
        return None
    return lambda a, it: on_sync(a.cpu().numpy(), it * 3)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 1-D tensor by a fixed pairwise tree of elementwise adds
    (x padded with zeros to a power of two; element i pairs with element i
    + half), so the CPU and the card add in the same order and give the
    same bits, as a reduction kernel of either does not."""
    n = x.numel()
    if n <= 1:
        return x.sum()
    x = torch.cat([x, x.new_zeros((1 << (n - 1).bit_length()) - n)])
    while x.numel() > 1:
        half = x.numel() // 2
        x = x[:half] + x[half:]
    return x[0]


def log_likelihood(ec: ECTable, alpha, eff) -> torch.Tensor:
    """L = sum_c n_c log(sum_{t in c} theta_t / eff_t), theta = alpha
    normalized; ECs with no mass contribute 0. A 0-d tensor on the host,
    with the same bits from the CPU and the card: every sum is taken in one
    fixed order (:func:`ordered_sum`; each EC's in nnz order,
    ``em_csr_cuda.ec_sums``: A4 on the card), and the logs are taken on
    the host, as the card's ``log`` may round otherwise."""
    from ..ops import em_csr_cuda

    theta = alpha / torch.clamp(ordered_sum(alpha), min=1e-300)
    w = theta[ec.txp_ids] / eff[ec.txp_ids]
    denom = em_csr_cuda.ec_sums(w, ec.ec_ids, ec.num_ecs).cpu()
    counts = ec.counts.cpu()
    return ordered_sum(torch.where(
        (counts > 0) & (denom > 0),
        counts * torch.log(torch.clamp(denom, min=1e-300)), 0.0))


def tpm_from_alpha(alpha, lengths, cfg: EMConfig):
    eff = effective_lengths(lengths, cfg, alpha.dtype, alpha.device)
    rate = torch.where(alpha > 0, alpha / eff, 0.0)
    s = rate.sum()
    return torch.where(s > 0, 1e6 * rate / s, 0.0)
