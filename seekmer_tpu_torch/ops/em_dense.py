"""The whole EM fixed point over a dense 0/1 membership matrix, plain PyTorch.

Counterpart of ``seekmer_tpu/ops/em_pallas.py`` ``em_fixed_point``: with M
in {0,1}^{E x T}, one iteration is

    x      = alpha * inv_eff
    denom  = x @ M^T                  (R, E)
    r      = n / denom, 0 where denom = 0
    alpha' = x * (r @ M)              (R, T)

run in blocks of ``check_every - 1`` raw steps and one monitored step, with
one host read of the converged flag per block (``em.run_blocked_fixed_point``,
the schedule of the JAX kernel and of the float64 oracle). The products are
``torch.matmul`` in the tensors' own dtype; for float32 on a card the caller
keeps ``torch.backends.cuda.matmul.allow_tf32`` False (the JAX kernel asks
for ``Precision.HIGHEST``). This is the version CPU tensors take and the one
K4 (``ops/em_cuda.py``) is held against.

Dropped from the JAX wrapper: the ``_round_up`` padding of E, T and R to the
TPU's (8, 128) tiles, and with it ``n_active_txp`` (nothing is padded, so
every transcript is real), and the scoped-VMEM limit of its compiler
parameters.
"""

from __future__ import annotations

import torch

from ..config import EMConfig
from ..em.em import run_blocked_fixed_point

# The VMEM byte budget of ``em_pallas.VMEM_BUDGET_BYTES``.
_BUDGET_BYTES = 8 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fits_dense(num_ecs: int, num_transcripts: int,
               replicates: int = 1) -> bool:
    """Whether a system takes the dense route: the formula of
    ``em_pallas.fits_pallas``, copied because that module imports JAX at
    the top. It keeps the reference's boundary, so the same systems take
    the same route in both packages; it is not reckoned for this card."""
    E = _round_up(max(num_ecs, 1), 128)
    T = _round_up(max(num_transcripts, 1), 128)
    R = _round_up(max(replicates, 1), 8)
    return 4 * (E * T + R * E * 2 + R * T * 2) <= _BUDGET_BYTES


def em_fixed_point(M: torch.Tensor, n: torch.Tensor, inv_eff: torch.Tensor,
                   alpha0: torch.Tensor, cfg: EMConfig):
    """EM to convergence on M [E, T], counts n [R, E], inv_eff [T] or
    [1, T] and alpha0 [R, T]. Returns (alpha [R, T], iterations). The
    convergence test is global over all R x T entries, as in the JAX
    kernel: every replicate iterates until all have converged."""
    inv_eff = inv_eff.reshape(1, -1)
    Mt = M.t()

    def one_iter(alpha):
        x = alpha * inv_eff
        denom = x @ Mt
        pos = denom > 0
        r = torch.where(pos, n / torch.where(pos, denom, 1.0), 0.0)
        return x * (r @ M)

    it, _, alpha = run_blocked_fixed_point(one_iter, alpha0, cfg)
    return alpha, it
