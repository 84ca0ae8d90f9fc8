"""A3: the CSR EM iteration, a block of steps a launch (``csrc/em_csr.cu``).

Replaces the XLA segment sums of ``seekmer_tpu/em/em.py`` ``em_step``
(single run) and ``seekmer_tpu/em/bootstrap.py`` ``_batched_iter`` (the
bootstrap's batched EM), which had no Pallas kernel and which the port's
plain versions run as torch gathers plus ``index_add_``. One cooperative
launch runs ``steps`` iterations: per step an E-phase (d = the sum of
w over each EC's members, into an (E, B) scratch), a grid barrier, an
M-phase (each transcript sums r = n w / d over its ECs in nnz order) and a
barrier. It returns the last two iterates, which the blocked schedule's
convergence test compares, so the iteration counts are those of the plain
version. Every sum runs in the order the CPU's ``index_add_`` adds and no
operation is contracted into an fma, so on the same inputs the kernel
gives the plain version's bits on the CPU, and the same bits every run.
"""

from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.float64)


def plain_steps(alpha, counts, scale, layout, steps: int, divide: bool):
    """``steps`` iterations of the plain version; returns the last two
    iterates (the first is ``alpha`` itself when ``steps`` is 1)."""
    from ..em.bootstrap import _batched_iter
    from ..em.em import ECTable, em_step

    E, T = layout.num_ecs, layout.num_transcripts
    if divide:
        ec = ECTable(counts.reshape(E), layout.ec_ids, layout.txp_ids, E, T)

        def em_iter(a):
            return em_step(a, ec, scale)
    else:
        em_iter = _batched_iter(counts.reshape(E, -1)[layout.ec_ids],
                                scale[layout.txp_ids][:, None],
                                layout.ec_ids, layout.txp_ids, E, T)
    prev, last = alpha, alpha
    for _ in range(steps):
        prev, last = last, em_iter(last)
    return prev, last


def em_steps(alpha: torch.Tensor, counts: torch.Tensor, scale: torch.Tensor,
             layout, steps: int, divide: bool):
    """``steps`` >= 1 EM iterations from ``alpha`` over ``layout``
    (``em.csr_layout``); returns (prev, last), the last two iterates.

    ``divide``: the single run of ``em_step``, alpha [T], counts [E],
    w = alpha / scale with scale the effective lengths. Else the batched
    form of ``_batched_iter``, alpha [T, B], counts [E, B], w = alpha *
    scale with scale their inverse. CPU tensors take the plain version;
    CUDA tensors the kernel, float32 or float64."""
    if steps < 1:
        raise ValueError("em_steps takes at least one step")
    if alpha.device.type == "cpu":
        return plain_steps(alpha, counts, scale, layout, steps, divide)
    E, T = layout.num_ecs, layout.num_transcripts
    if divide != (alpha.dim() == 1):
        raise ValueError("divide takes alpha [T], the batched form [T, B]")
    B = alpha.shape[1] if alpha.dim() == 2 else 1
    if alpha.dtype not in DTYPES or any(t.dtype != alpha.dtype
                                        for t in (counts, scale)):
        raise ValueError("the CSR EM kernel takes float32 or float64 "
                         "tensors of one type")
    if (alpha.shape[0] != T or counts.numel() != E * B
            or counts.shape[0] != E or scale.shape != (T,)):
        raise ValueError(f"shapes alpha {tuple(alpha.shape)}, counts "
                         f"{tuple(counts.shape)}, scale {tuple(scale.shape)} "
                         f"do not fit E {E}, T {T}")
    if max(E, T) * B >= 2**31:
        raise ValueError(f"{max(E, T)} x {B} entries exceed the kernel's "
                         "int32 indices")
    _build.require_cuda("em_steps", alpha, counts, scale, layout.ec_off,
                        layout.txp, layout.txp_off, layout.csc_ec)
    if alpha.numel() == 0:
        return alpha, alpha.clone()
    d = torch.empty((E, B), dtype=alpha.dtype, device=alpha.device)
    bufs = [torch.empty_like(alpha) for _ in range(min(steps, 2))]
    fn = _build.function("seekmer_em_csr", 11, 7)
    _build.check(fn(alpha.data_ptr(), counts.data_ptr(), scale.data_ptr(),
                    layout.ec_off.data_ptr(), layout.txp.data_ptr(),
                    layout.txp_off.data_ptr(), layout.csc_ec.data_ptr(),
                    d.data_ptr(), bufs[0].data_ptr(), bufs[-1].data_ptr(),
                    _build.stream_of(alpha), alpha.device.index, E, T, B,
                    steps, int(divide), int(alpha.dtype == torch.float64)),
                 "em_csr")
    em_steps.launches += 1
    # step s writes bufs[s % 2]
    last = bufs[(steps - 1) % 2]
    return (alpha if steps == 1 else bufs[steps % 2]), last


em_steps.launches = 0
