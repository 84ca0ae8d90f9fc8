"""A3: the CSR EM fixed point in one launch (``csrc/em_csr.cu``).

Replaces the XLA segment sums of ``seekmer_tpu/em/em.py`` ``em_step``
(single run) and ``seekmer_tpu/em/bootstrap.py`` ``_batched_iter`` (the
bootstrap's batched EM), driven by ``run_blocked_fixed_point``'s
``while_loop``; the JAX package had no Pallas kernel for them, and the
port's plain versions run them as torch gathers plus ``index_add_``.

``em_fixed_point`` runs the whole blocked fixed point in one cooperative
launch: blocks of ``check_every`` steps, after each the convergence test
between the block's last two iterates, on the card, and one read back of
the iteration count at the end. The table is cut along its connected
components into tiles (``tiled_layout``) that each fit one thread
block's shared memory at a slice of up to 32 replicates; a block runs a
tile's E and M phases there with ``__syncthreads()`` alone. Components too
large for a tile take a global route in the same launch, with grid
barriers. ``em_steps`` is the same launch with the test off: ``steps``
iterations, the last two iterates back (SQUAREM calls it a step at a
time). Every sum runs in the order the CPU's ``index_add_`` adds and no
operation is contracted into an fma, so on the same inputs the kernel
gives the plain version's bits on the CPU, and its iteration count.

``rel_tol``, ``abs_floor`` and ``count_floor`` go to the C entry as
doubles and are rounded to the iterate's type there, as torch rounds a
Python float compared with or added to a float32 tensor. A fixed point
counts one launch in ``em_steps.launches``, as does an ``em_steps`` call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

DTYPES = (torch.float32, torch.float64)


def plain_iter(counts, scale, layout, divide: bool):
    """One plain iteration as a function of the iterate: ``em_step``
    (``divide``) or ``_batched_iter``."""
    from ..em.bootstrap import _batched_iter
    from ..em.em import ECTable, em_step

    E, T = layout.num_ecs, layout.num_transcripts
    if divide:
        ec = ECTable(counts.reshape(E), layout.ec_ids, layout.txp_ids, E, T)
        return lambda a: em_step(a, ec, scale)
    return _batched_iter(counts.reshape(E, -1)[layout.ec_ids],
                         scale[layout.txp_ids][:, None], layout.ec_ids,
                         layout.txp_ids, E, T)


def plain_steps(alpha, counts, scale, layout, steps: int, divide: bool):
    """``steps`` iterations of the plain version; returns the last two
    iterates (the first is ``alpha`` itself when ``steps`` is 1)."""
    em_iter = plain_iter(counts, scale, layout, divide)
    prev, last = alpha, alpha
    for _ in range(steps):
        prev, last = last, em_iter(last)
    return prev, last


def plain_fixed_point(alpha0, counts, scale, layout, cfg, divide: bool,
                      it_init: int = 0):
    """The plain fixed point: ``run_blocked_fixed_point`` a block of plain
    steps at a time. Returns (alpha, it, converged)."""
    from ..em.em import run_blocked_fixed_point

    it, converged, alpha = run_blocked_fixed_point(
        plain_iter(counts, scale, layout, divide), alpha0, cfg,
        it_init=it_init, em_block=lambda a, steps: plain_steps(
            a, counts, scale, layout, steps, divide))
    return alpha, it, converged


def _check(name, alpha, counts, scale, layout, divide):
    """Reject what the kernel does not take; returns B."""
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
    _build.require_cuda(name, alpha, counts, scale, layout.ec_off,
                        layout.txp, layout.txp_off, layout.csc_ec)
    return B


@functools.lru_cache(maxsize=None)
def grid_shape(device: int, dbl: bool):
    """(blocks, bytes): the blocks of A3's grid the card holds at once,
    and the shared memory each may take."""
    out = (ctypes.c_int64 * 2)()
    _build.check(_build.function("seekmer_em_csr_shape", 1, 2)(
        ctypes.addressof(out), device, int(dbl)), "em_csr")
    return int(out[0]), int(out[1])


SLICE_MAX = 32  # replicates of a slice at most: a warp's lanes


def slicing(replicates: int) -> Tuple[int, int]:
    """(width, slices): the replicates cut into the fewest slices of at
    most ``SLICE_MAX``, as even as they go (100 -> 4 of 25)."""
    slices = -(-max(replicates, 1) // SLICE_MAX)
    return -(-max(replicates, 1) // slices), slices


def item_bytes(E, T, Z, width: int, elem: int):
    """Shared memory a tile of E ECs, T transcripts and Z entries takes
    at ``width`` replicates: its local CSR and CSC offsets and indices and
    each CSC entry's transcript (int32), padded to 16 bytes, then n and d
    side by side, the scale, the iterate, its weights and each entry's r
    (``elem`` bytes each). The kernel's ``load`` carves a block's shared
    memory so."""
    return ((4 * (E + T + 2 + 3 * Z) + 15) // 16 * 16
            + elem * (T + width * (2 * T + 2 * E + Z)))


class TiledLayout(NamedTuple):
    """A ``CSRLayout`` cut along the connected components of the
    EC-transcript graph into tiles that each fit one thread block's shared
    memory at the slice width, for A3. Tile i (``i < ntiles``) holds the
    transcripts ``rows_t[tile_t0[i]:tile_t0[i + 1]]`` and the ECs
    ``rows_e[tile_e0[i]:tile_e0[i + 1]]`` (global ids, in local order:
    longest row first);
    its local CSR is ``ec_off[tile_e0[i] + i:tile_e0[i + 1] + i + 1]``
    (offsets from ``tile_z0[i]``) over ``txp[tile_z0[i]:tile_z0[i + 1]]``
    (local transcript indices), its local CSC ``txp_off`` and ``csc``
    (local EC indices) likewise. Entry ``ntiles`` is the global set, the
    components too large for a tile, whose ``txp`` holds global
    transcript ids. Every row keeps its ``CSRLayout`` order, so every sum
    adds in the CPU's order. ``resident``: every (tile, slice) item has a
    block of its own, so tiles stay in shared memory for the whole
    launch."""

    width: int  # replicates of a slice
    slices: int
    ntiles: int
    smem: int  # bytes of shared memory the largest item takes
    resident: bool
    tile_t0: torch.Tensor  # int32[ntiles + 2]
    tile_e0: torch.Tensor  # int32[ntiles + 2]
    tile_z0: torch.Tensor  # int32[ntiles + 2]
    rows_t: torch.Tensor  # int32[T]
    rows_e: torch.Tensor  # int32[E]
    ec_off: torch.Tensor  # int32[E + ntiles + 1]
    txp: torch.Tensor  # int32[nnz]
    txp_off: torch.Tensor  # int32[T + ntiles + 1]
    csc: torch.Tensor  # int32[nnz]
    components: int
    largest: Tuple[int, int]  # (transcripts, ECs) of the largest component
    global_rows: Tuple[int, int]  # (transcripts, ECs) of the global set

    def index_bytes(self) -> int:
        """Bytes of the layout's index arrays, which a launch reads."""
        return sum(t.numel() * t.element_size() for t in (
            self.tile_t0, self.tile_e0, self.tile_z0, self.rows_t,
            self.rows_e, self.ec_off, self.txp, self.txp_off, self.csc))


def _runs(starts, lens, total: int):
    """Indices of the runs [starts[i], starts[i] + lens[i]) one after
    another (``total`` of them)."""
    first = torch.cumsum(lens, 0) - lens
    return (torch.repeat_interleave(starts - first, lens, output_size=total)
            + torch.arange(total, device=lens.device))


def _local_offsets(deg, row0, z0, ntiles: int):
    """Each tile's offsets over its rows (``deg`` in local order, tile i's
    rows at ``row0[i]:row0[i + 1]``), from 0, one more than its rows."""
    dev = deg.device
    glob = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
    n_i = torch.diff(row0) + 1
    size = deg.numel() + ntiles + 1
    tile = torch.repeat_interleave(torch.arange(ntiles + 1, device=dev), n_i,
                                   output_size=size)
    j = torch.arange(size, device=dev) - torch.repeat_interleave(
        torch.cumsum(n_i, 0) - n_i, n_i, output_size=size)
    return glob[row0[tile] + j] - z0[tile]


def components(ec_off, txp, txp_off, csc_ec):
    """Connected components of the EC-transcript graph from the CSR and
    CSC (int64 tensors, on their device): each transcript takes the least
    transcript id it reaches, by minima over each EC's members and each
    transcript's ECs and pointer jumping, until nothing moves. Returns
    (count, label of each transcript, label of each EC), labels numbered
    in the order of each component's least transcript, ECs with no member
    last."""
    dev = txp.device
    T, E, Z = txp_off.numel() - 1, ec_off.numel() - 1, txp.numel()
    deg_e, deg_t = torch.diff(ec_off), torch.diff(txp_off)
    ec_of = torch.repeat_interleave(torch.arange(E, device=dev), deg_e,
                                    output_size=Z)
    t_of = torch.repeat_interleave(torch.arange(T, device=dev), deg_t,
                                   output_size=Z)
    own_e = torch.arange(T, T + E, device=dev)  # an EC with no member
    lab = torch.arange(T, device=dev)
    while True:
        lab_e = own_e.scatter_reduce(0, ec_of, lab[txp], "amin")
        new = lab.scatter_reduce(0, t_of, lab_e[csc_ec], "amin")
        while True:
            up = new[new]
            if torch.equal(up, new):
                break
            new = up
        if torch.equal(new, lab):
            break
        lab = new
    root = torch.zeros(T + E, dtype=torch.int64, device=dev)
    root[lab] = 1
    root[lab_e] = 1
    dense = torch.cumsum(root, 0) - 1
    return int(root.sum()), dense[lab], dense[lab_e]


def tiled_layout(layout, replicates: int, elem: int,
                 capacity: int, blocks: int) -> TiledLayout:
    """Cut ``layout`` (``em.csr_layout``) into tiles for ``replicates``
    replicates of ``elem`` bytes, each (tile, slice) item taking at most
    ``capacity`` bytes of shared memory, for a grid of ``blocks`` blocks
    resident at once. Built
    with torch ops on the layout's device once per fixed point
    (``layout.tilings`` caches it).

    The components are cut in order into tiles of about equal work
    (entries and rows): as many as the grid holds at once when everything
    fits at 90% of ``capacity`` (resident), else whole rounds of the grid.
    Where a tile of that cut would not fit ``capacity`` (large components
    side by side), the cut is made finer, by a round of the grid or a
    quarter, whichever is more, until every tile fits: at one tile a unit
    of work each component stands alone. A component that does not fit a
    tile alone goes to the global set."""
    width, slices = slicing(replicates)
    E, T = layout.num_ecs, layout.num_transcripts
    i64 = torch.int64
    ec_off, txp, txp_off, csc_ec = (t.to(i64) for t in (
        layout.ec_off, layout.txp, layout.txp_off, layout.csc_ec))
    dev, Z = txp.device, txp.numel()
    deg_e, deg_t = torch.diff(ec_off), torch.diff(txp_off)
    ec_of = torch.repeat_interleave(torch.arange(E, device=dev), deg_e,
                                    output_size=Z)
    K, comp_t, comp_e = components(ec_off, txp, txp_off, csc_ec)
    nt = torch.bincount(comp_t, minlength=K)
    ne = torch.bincount(comp_e, minlength=K)
    nz = torch.bincount(comp_e[ec_of], minlength=K)
    # bytes a component adds to a tile (a tile's own 8 offsets and padding
    # apart), and its work: a quotient per entry weighs about two sums
    own = (4 * (ne + nt + 3 * nz)
           + elem * (nt + width * (2 * nt + 2 * ne + nz)))
    fixed = 8 + 15
    small = torch.nonzero(own + fixed <= capacity).flatten()
    tile_of = torch.full((K,), -1, dtype=i64, device=dev)
    if small.numel():
        sizes, work = own[small], (3 * nz + ne + nt)[small]
        total = int(work.sum())
        fewest = -(-int(sizes.sum()) // max(int(0.9 * capacity) - fixed, 1))
        per_round = max(blocks // slices, 1)
        n = min(per_round * -(-fewest // per_round), total)
        start = torch.cumsum(work, 0) - work
        while True:
            tiles = torch.unique(start * n // total, return_inverse=True)[1]
            if n == total or not bool((torch.bincount(
                    tiles, weights=sizes.double()) + fixed > capacity).any()):
                break
            n = min(max(n + per_round, n * 5 // 4), total)
        tile_of[small] = tiles
    ntiles = int(tile_of.max()) + 1 if small.numel() else 0
    tile_of[tile_of < 0] = ntiles  # the global set
    # a tile's rows longest first, so that the rows a block's threads take
    # in turn are of even length (the order of every sum stays the CSR's)
    t_tile, e_tile = tile_of[comp_t], tile_of[comp_e]
    rows_t = torch.argsort(t_tile * (Z + 1) + Z - deg_t, stable=True)
    rows_e = torch.argsort(e_tile * (Z + 1) + Z - deg_e, stable=True)

    def starts(rows_tile):
        return torch.cat([rows_tile.new_zeros(1), torch.cumsum(
            torch.bincount(rows_tile, minlength=ntiles + 1), 0)])

    tile_t0, tile_e0 = starts(t_tile), starts(e_tile)
    loc_t = torch.empty(T, dtype=i64, device=dev)
    loc_e = torch.empty(E, dtype=i64, device=dev)
    loc_t[rows_t] = torch.arange(T, device=dev) - tile_t0[t_tile[rows_t]]
    loc_e[rows_e] = torch.arange(E, device=dev) - tile_e0[e_tile[rows_e]]
    # the entries by tile: each EC's members in CSR order, each
    # transcript's ECs in CSC order
    by_ec = _runs(ec_off[:-1][rows_e], deg_e[rows_e], Z)
    by_txp = _runs(txp_off[:-1][rows_t], deg_t[rows_t], Z)
    z_tile = e_tile[ec_of[by_ec]]
    tile_z0 = starts(z_tile)
    members = txp[by_ec]
    local_txp = torch.where(z_tile < ntiles, loc_t[members], members)
    local_ec_off = _local_offsets(deg_e[rows_e], tile_e0, tile_z0, ntiles)
    local_txp_off = _local_offsets(deg_t[rows_t], tile_t0, tile_z0, ntiles)
    sizes_t, sizes_e = torch.diff(tile_t0), torch.diff(tile_e0)
    smem = (int(item_bytes(sizes_e[:ntiles], sizes_t[:ntiles],
                           torch.diff(tile_z0)[:ntiles], width, elem).max())
            if ntiles else 0)
    big = int(torch.argmax(nt + ne)) if K else 0

    def i32(t):
        return t.to(torch.int32).contiguous()

    return TiledLayout(
        width, slices, ntiles, smem, ntiles * slices <= blocks,
        i32(tile_t0), i32(tile_e0), i32(tile_z0), i32(rows_t), i32(rows_e),
        i32(local_ec_off), i32(local_txp), i32(local_txp_off),
        i32(loc_e[csc_ec[by_txp]]), K,
        (int(nt[big]), int(ne[big])) if K else (0, 0),
        (int(sizes_t[ntiles]), int(sizes_e[ntiles])))


def tiling(layout, replicates: int, dtype: torch.dtype):
    """The layout's ``tiled_layout`` for this card, ``replicates`` and
    ``dtype``, built once and kept in ``layout.tilings``."""
    blocks, capacity = grid_shape(layout.ec_off.get_device(),
                                  dtype == torch.float64)
    elem = torch.empty(0, dtype=dtype).element_size()
    key = (replicates, elem, capacity, blocks)
    if key not in layout.tilings:
        layout.tilings[key] = tiled_layout(layout, replicates, elem,
                                           capacity, blocks)
    return layout.tilings[key]


def _launch(alpha0, counts, scale, layout, B, divide, C, max_iters,
            min_iters, it_init, tols, test, keep_prev):
    """One launch; returns (last iterate, previous iterate or None, the
    state: 6 slot words, then it and converged)."""
    tl = tiling(layout, B, alpha0.dtype)
    dev = alpha0.device
    out = torch.empty_like(alpha0)
    prev = torch.empty_like(alpha0) if keep_prev else None
    dg = torch.empty(tl.global_rows[1] * B, dtype=alpha0.dtype, device=dev)
    state = torch.zeros(8, dtype=torch.int64, device=dev)
    blocks, _ = grid_shape(dev.index, alpha0.dtype == torch.float64)
    fn = _build.function("seekmer_em_csr", 17, 15, 3)
    _build.check(fn(
        alpha0.data_ptr(), out.data_ptr(),
        prev.data_ptr() if keep_prev else 0, counts.data_ptr(),
        scale.data_ptr(), dg.data_ptr(), tl.tile_t0.data_ptr(),
        tl.tile_e0.data_ptr(), tl.tile_z0.data_ptr(), tl.rows_t.data_ptr(),
        tl.rows_e.data_ptr(), tl.ec_off.data_ptr(), tl.txp.data_ptr(),
        tl.txp_off.data_ptr(), tl.csc.data_ptr(), state.data_ptr(),
        _build.stream_of(alpha0), dev.index, tl.ntiles, B, tl.width,
        tl.slices, tl.smem, blocks, int(tl.resident), C, max_iters,
        min_iters, it_init, int(test), int(divide),
        int(alpha0.dtype == torch.float64), *tols), "em_csr")
    em_steps.launches += 1
    return out, prev, state


def em_fixed_point(alpha0: torch.Tensor, counts: torch.Tensor,
                   scale: torch.Tensor, layout, cfg, divide: bool,
                   it_init: int = 0):
    """The blocked EM fixed point from ``alpha0`` over ``layout``
    (``em.csr_layout``) under ``cfg`` (check_every, min_iters, max_iters,
    rel_tol, abs_floor, count_floor); ``it`` counts from ``it_init``.
    Returns (alpha, it, converged). ``divide`` and the shapes as
    ``em_steps``. CPU tensors take the plain version
    (``plain_fixed_point``); CUDA tensors one launch of the kernel and
    one read back."""
    if alpha0.device.type == "cpu":
        return plain_fixed_point(alpha0, counts, scale, layout, cfg, divide,
                                 it_init)
    B = _check("em_fixed_point", alpha0, counts, scale, layout, divide)
    if alpha0.numel() == 0:
        raise ValueError("em_fixed_point takes a non-empty iterate")
    if it_init >= cfg.max_iters:
        return alpha0, it_init, False
    out, _, state = _launch(
        alpha0, counts, scale, layout, B, divide, max(cfg.check_every, 1),
        cfg.max_iters, cfg.min_iters, it_init,
        (cfg.rel_tol, cfg.abs_floor, cfg.count_floor), True, False)
    it, converged = state[6:8].tolist()
    return out, it, bool(converged)


def em_steps(alpha: torch.Tensor, counts: torch.Tensor, scale: torch.Tensor,
             layout, steps: int, divide: bool):
    """``steps`` >= 1 EM iterations from ``alpha`` over ``layout``
    (``em.csr_layout``); returns (prev, last), the last two iterates.

    ``divide``: the single run of ``em_step``, alpha [T], counts [E],
    w = alpha / scale with scale the effective lengths. Else the batched
    form of ``_batched_iter``, alpha [T, B], counts [E, B], w = alpha *
    scale with scale their inverse. CPU tensors take the plain version;
    CUDA tensors the kernel (the fixed point's launch with the test off),
    float32 or float64, and no read back."""
    if steps < 1:
        raise ValueError("em_steps takes at least one step")
    if alpha.device.type == "cpu":
        return plain_steps(alpha, counts, scale, layout, steps, divide)
    B = _check("em_steps", alpha, counts, scale, layout, divide)
    if alpha.numel() == 0:
        return alpha, alpha.clone()
    out, prev, _ = _launch(alpha, counts, scale, layout, B, divide, steps,
                           steps, 0, 0, (0.0, 0.0, 0.0), False, steps > 1)
    return (alpha if steps == 1 else prev), out


em_steps.launches = 0


def plain_ec_sums(w: torch.Tensor, ec_ids: torch.Tensor,
                  E: int) -> torch.Tensor:
    """A4's plain version: each EC's sum of the terms w[nnz] (``ec_ids``
    sorted), added in nnz order from 0, the order in which ``index_add_``
    adds on the CPU, by one elementwise add a rank over the ECs that have
    a term of that rank (ECs by size, largest first): the same bits on
    either device. Reads the sizes' histogram back once."""
    size = torch.bincount(ec_ids, minlength=E)
    order = torch.sort(size, descending=True, stable=True).indices
    start = (torch.cumsum(size, 0) - size)[order]
    # ECs with more than r terms, for each rank r
    longer = E - torch.cumsum(torch.bincount(size), 0)[:-1].cpu()
    acc = w.new_zeros(E)
    for r, k in enumerate(longer.tolist()):
        acc[:k] += w[start[:k] + r]
    return torch.empty_like(acc).index_copy_(0, order, acc)


def ec_sums(w: torch.Tensor, ec_ids: torch.Tensor, E: int) -> torch.Tensor:
    """A4: each EC's sum of the terms w[nnz] (``ec_ids`` sorted, int64, in
    [0, E)), in nnz order from 0, [E] of w's type: the order of the CPU's
    ``index_add_`` and of A3's E-phase, so the card gives the CPU's bits,
    which ``index_add_``'s atomics on the card do not. CPU tensors take
    the plain version; CUDA tensors the kernel (float32 or float64, one
    launch over the sorted ids, no offsets built, no read back; a table
    with no term is one memset and no launch)."""
    if w.device.type == "cpu":
        return plain_ec_sums(w, ec_ids, E)
    if (w.dtype not in DTYPES or w.dim() != 1 or ec_ids.shape != w.shape
            or ec_ids.dtype != torch.int64):
        raise ValueError("ec_sums takes float32 or float64 w [nnz] and its "
                         "int64 ec_ids [nnz]")
    if w.numel() >= 2**31 or E >= 2**31:
        raise ValueError("EC tables of 2^31 entries or more do not fit "
                         "A4's int32 indices")
    if E == 0:
        return w.new_empty(0)
    w, ec_ids = w.contiguous(), ec_ids.contiguous()
    out = torch.empty(E, dtype=w.dtype, device=w.device)
    _build.require_cuda("ec_sums", w, ec_ids, out)
    nnz = w.numel()
    fn = _build.function("seekmer_ec_sum", 4, 4)
    _build.check(fn(w.data_ptr(), ec_ids.data_ptr(), out.data_ptr(),
                    _build.stream_of(w), w.device.index, nnz, E,
                    int(w.dtype == torch.float64)), "ec_sum")
    ec_sums.launches += nnz > 0
    return out


ec_sums.launches = 0
