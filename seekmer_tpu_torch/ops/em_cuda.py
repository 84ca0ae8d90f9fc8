"""K4: the whole dense EM fixed point in one launch (``csrc/em.cu``).

Replaces ``seekmer_tpu/ops/em_pallas.py`` ``_em_kernel`` (R > 1) and
``_em_kernel_r1`` (R = 1), reached through ``em_fixed_point``. One
persistent cooperative kernel runs every ``check_every`` block and the
global convergence test on the card and returns alpha and the iteration
count; there is no per-iteration dispatch and no host read until the end.
It is bound by its shared-memory tile reads (five per four FMAs a thread)
over a serial depth loop per tile, plus two grid syncs an iteration; see
the source note.

``rel_tol``, ``abs_floor`` and ``count_floor`` go to the C entry as
doubles (``_build.function``'s ``n_dbl``) and are rounded to float32
there, as the float32 comparisons of the plain version round them.
"""

from __future__ import annotations

import torch

from seekmer_tpu.config import EMConfig

from . import _build
from .em_dense import em_fixed_point as plain


def em_fixed_point(M: torch.Tensor, n: torch.Tensor, inv_eff: torch.Tensor,
                   alpha0: torch.Tensor, cfg: EMConfig):
    """EM to convergence on the dense membership M [E, T] for counts n
    [R, E], inv_eff [T] or [1, T] and alpha0 [R, T]; returns (alpha
    [R, T], iterations). CPU tensors take the plain version
    (``em_dense.em_fixed_point``); CUDA tensors the kernel, float32 only."""
    if M.device.type == "cpu":
        return plain(M, n, inv_eff, alpha0, cfg)
    E, T = M.shape
    R = n.shape[0]
    inv_eff = inv_eff.reshape(-1)
    if any(t.dtype != torch.float32 for t in (M, n, inv_eff, alpha0)):
        raise ValueError("the dense EM kernel takes float32 tensors only")
    if n.shape != (R, E) or inv_eff.shape != (T,) or alpha0.shape != (R, T):
        raise ValueError(f"shapes M {tuple(M.shape)}, n {tuple(n.shape)}, "
                         f"inv_eff {tuple(inv_eff.shape)}, alpha0 "
                         f"{tuple(alpha0.shape)} do not fit together")
    _build.require_cuda("em_fixed_point", M, n, inv_eff, alpha0)
    dev = M.device
    alpha = torch.empty((R, T), dtype=torch.float32, device=dev)
    x = torch.empty((R, T), dtype=torch.float32, device=dev)
    r = torch.empty((R, E), dtype=torch.float32, device=dev)
    slots = torch.empty(4, dtype=torch.int32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    fn = _build.function("seekmer_em_fixed_point", 10, 7, 3)
    _build.check(fn(M.data_ptr(), n.data_ptr(), inv_eff.data_ptr(),
                    alpha0.data_ptr(), alpha.data_ptr(), x.data_ptr(),
                    r.data_ptr(), slots.data_ptr(), iters.data_ptr(),
                    _build.stream_of(M), dev.index, E, T, R,
                    cfg.check_every, cfg.max_iters, cfg.min_iters,
                    cfg.rel_tol, cfg.abs_floor, cfg.count_floor),
                 "em_fixed_point")
    em_fixed_point.launches += 1
    return alpha, int(iters.item())


em_fixed_point.launches = 0
