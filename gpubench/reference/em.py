"""EM over equivalence-class counts and the fragment-length estimate, in
plain PyTorch, in any floating dtype: float64 for the reference, a lower
one for the control.

EM (kallisto's): with theta_t the expected fragments of transcript t and
l_t its effective length, one step is

    theta'_t = sum over classes c holding t of n_c (theta_t / l_t) /
               sum_{u in c} (theta_u / l_u)

from theta = N / T everywhere. It runs in blocks of ``check_every``
steps; after a block it stops when, over transcripts with theta' above
``count_floor``, the largest |theta' - theta| / (theta' + abs_floor)
between the block's last two steps is below ``rel_tol`` (and at least
``min_iters`` steps are done), or after ``max_iters`` steps.

Sums in the lower precision are taken in that precision: ``index_add_``
adds into a tensor of the dtype, and :func:`pairwise_sum` rounds every
partial sum.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along dim 0 by a pairwise tree in x's dtype (no wider
    accumulator)."""
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(x.shape[1:])
    size = 1 << (n - 1).bit_length()
    if size > n:
        x = torch.cat([x, x.new_zeros((size - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def effective_lengths(lengths: torch.Tensor, mean: float, sd: float,
                      dtype=torch.float64) -> torch.Tensor:
    """max(len - mean + 1, 1) for sd = 0; otherwise the expectation of
    len - f + 1 under a normal fragment length f ~ N(mean, sd) restricted
    to the integers 1 .. min(len, ceil(mean + 5 sd)), floored at 1."""
    l = lengths.to(dtype)
    if sd <= 0:
        return torch.clamp(l - mean + 1.0, min=1.0)
    F = int(math.ceil(mean + 5.0 * sd))
    f = torch.arange(1, F + 1, dtype=dtype, device=lengths.device)
    pdf = torch.exp(-0.5 * ((f - mean) / sd) ** 2)
    c0 = torch.cumsum(pdf, 0)
    c1 = torch.cumsum(pdf * f, 0)
    idx = torch.clamp(lengths.to(torch.int64), 1, F) - 1
    return torch.clamp((l + 1.0) - c1[idx] / c0[idx], min=1.0)


class ECs:
    """Equivalence classes as flat (class, transcript) pairs."""

    def __init__(self, ec_off: torch.Tensor, ec_tids: torch.Tensor, T: int):
        E = ec_off.numel() - 1
        self.E, self.T = E, T
        self.ec = torch.repeat_interleave(
            torch.arange(E, device=ec_off.device), ec_off[1:] - ec_off[:-1])
        self.txp = ec_tids.to(torch.int64)


def em_step(theta, ecs: ECs, counts, inv_len):
    """One step; theta [T] or [T, B], counts [E] or [E, B]."""
    w = theta[ecs.txp] * (inv_len[ecs.txp] if theta.dim() == 1
                          else inv_len[ecs.txp][:, None])
    denom = torch.zeros((ecs.E,) + tuple(w.shape[1:]), dtype=w.dtype,
                        device=w.device).index_add_(0, ecs.ec, w)
    d = denom[ecs.ec]
    r = torch.where(d > 0, counts[ecs.ec] * w / d, torch.zeros_like(w))
    return torch.zeros((ecs.T,) + tuple(w.shape[1:]), dtype=w.dtype,
                       device=w.device).index_add_(0, ecs.txp, r)


def rel_change(old, new, abs_floor: float, count_floor: float):
    """The stopping statistic: the largest relative change over active
    transcripts (per replicate for [T, B]), and whether any is active."""
    active = new > count_floor
    rel = torch.abs(new - old) / (new + abs_floor)
    rel = torch.where(active, rel, torch.zeros_like(rel))
    return rel.amax(dim=0), active.any(dim=0)


def run(ecs: ECs, counts: torch.Tensor, eff: torch.Tensor, em: dict,
        dtype=torch.float64, iters: Optional[int] = None):
    """EM from N / T (per replicate for counts [E, B]). With ``iters`` it
    runs exactly that many steps; otherwise it stops by the rule above.
    Returns (theta, steps, statistic at the end); replicates share one
    test, over all of them, as the program's batched EM does."""
    counts = counts.to(dtype)
    inv_len = 1.0 / eff.to(dtype)
    total = pairwise_sum(counts)
    theta = (total / ecs.T).expand((ecs.T,) + tuple(counts.shape[1:]))
    theta = theta.contiguous()
    C = max(int(em["check_every"]), 1)
    it, stat = 0, float("nan")
    while True:
        if iters is not None and it >= iters:
            break
        steps = C if iters is None else min(C, iters - it)
        for _ in range(steps):
            old, theta = theta, em_step(theta, ecs, counts, inv_len)
        it += steps
        rel, any_active = rel_change(old, theta, em["abs_floor"],
                                     em["count_floor"])
        stat = float(rel.max()) if rel.numel() else 0.0
        if iters is None:
            done = (it >= em["min_iters"] and bool(any_active.any())
                    and stat < em["rel_tol"])
            if done or it >= em["max_iters"]:
                break
    return theta, it, stat


def fld_estimate(hist: torch.Tensor, dtype=torch.float64,
                 min_samples: int = 100):
    """(mean, sd with n - 1, n) of a fragment-length histogram (index 0
    ignored), or None below ``min_samples``."""
    h = hist.clone()
    h[0] = 0
    n = int(h.sum())
    if n < min_samples:
        return None
    f = torch.arange(h.numel(), dtype=dtype, device=h.device)
    hd = h.to(dtype)
    nn = torch.tensor(float(n), dtype=dtype, device=h.device)
    mean = pairwise_sum(f * hd) / nn
    var = pairwise_sum((f - mean) ** 2 * hd) / (nn - 1)
    return float(mean), float(torch.sqrt(var)), n
