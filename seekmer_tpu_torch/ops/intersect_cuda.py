"""I2: the member lists of the multi-EC signatures intersected
(``csrc/intersect.cu``).

Replaces no TPU kernel: the JAX package resolves signatures on the host
(``seekmer_tpu/map/driver.py:638`` ``resolve_signatures``, one
``np.intersect1d`` a class past the first of every signature of two or
more ECs). On the card one launch intersects every such row: a warp a row,
the shortest list's members binary-searched in the row's other lists, the
survivors compacted in order by a ballot. The kernel is bound by the
bytes (each row, list bound and member read once, each survivor written
once); a call's time is its launch and its read-backs.

Every row gets a slot as long as its shortest list, the most its
intersection can hold; the slots' starts are the exclusive scan of those
lengths, computed here with one gather over the offsets and a cumsum, so
the kernel allocates nothing. CPU tensors take :func:`plain`, which
computes the same slots another way: it gathers every (row, EC) pair's
members, counts each (row, transcript) pair and keeps those counted once
for each of the row's ECs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

SIG_PAD = 0x7FFFFFFF
MAX_WIDTH = 768  # ECs a row: the kernel keeps C (start, length) pairs a
# warp in shared memory, 8 warps a block, within the 48 KB a launch may take


class Intersections(NamedTuple):
    """Row i's intersection, sorted ascending, is ``values[starts[i] :
    starts[i] + lens[i]]``; ``lens[i]`` 0 is an empty one. ``members`` is
    the summed length of every EC list of every row, the work given;
    ``on_device``, whether this call launched I2."""

    values: torch.Tensor  # int32[sum of the slots]
    starts: torch.Tensor  # int64[M]
    lens: torch.Tensor  # int32[M]
    members: int
    on_device: bool = False


def _check(rows, ec_offsets, ec_transcripts) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows are int32 (M, C), got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[1] > MAX_WIDTH:
        raise ValueError(f"rows of {rows.shape[1]} ECs: the kernel takes at "
                         f"most {MAX_WIDTH}")
    for name, t in (("ec_offsets", ec_offsets),
                    ("ec_transcripts", ec_transcripts)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} is int32 (n,), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (rows, ec_offsets, ec_transcripts):
        if not t.is_contiguous():
            raise ValueError("intersect: tensors must be contiguous")


def _slots(rows, ec_offsets):
    """The mask of real ECs (M, C), each one's list length (0 at a pad),
    each row's slot start, and as one int64[2] tensor the slots' total
    length and the summed list lengths."""
    real = rows != SIG_PAD
    ec = torch.where(real, rows, 0).to(torch.int64)
    bounds = ec_offsets.to(torch.int64)[torch.stack([ec, ec + 1])]
    length = torch.where(real, bounds[1] - bounds[0], 0)
    shortest = torch.where(real, length, torch.iinfo(torch.int64).max)
    cap = torch.where(real.any(dim=1), shortest.amin(dim=1), 0)
    ends = torch.cumsum(cap, 0)
    totals = torch.stack([ends[-1], length.sum()])
    return real, length, ends - cap, totals


def _empty(rows) -> Intersections:
    dev = rows.device
    return Intersections(torch.empty(0, dtype=torch.int32, device=dev),
                         torch.empty(0, dtype=torch.int64, device=dev),
                         torch.empty(0, dtype=torch.int32, device=dev), 0)


def plain(rows: torch.Tensor, ec_offsets: torch.Tensor,
          ec_transcripts: torch.Tensor) -> Intersections:
    """The intersections in the kernel's slots, in PyTorch on the tensors'
    device (the wrapper takes it for CPU tensors)."""
    _check(rows, ec_offsets, ec_transcripts)
    M, dev = rows.shape[0], rows.device
    if M == 0:
        return _empty(rows)
    real, length, starts, totals = _slots(rows, ec_offsets)
    total, members = totals.tolist()
    n_ec = real.sum(dim=1)
    pair_row = torch.arange(M, device=dev).repeat_interleave(n_ec)
    pair_len = length[real]
    pair_start = ec_offsets.to(torch.int64)[rows[real].to(torch.int64)]
    elem_pair = torch.arange(pair_len.numel(),
                             device=dev).repeat_interleave(pair_len)
    within = torch.arange(members, device=dev) - (torch.cumsum(pair_len, 0)
                                                  - pair_len)[elem_pair]
    t = ec_transcripts[pair_start[elem_pair] + within].to(torch.int64)
    key, seen = torch.unique((pair_row[elem_pair] << 32) | t,
                             return_counts=True)
    row = key >> 32
    whole = seen == n_ec[row]
    row, t = row[whole], key[whole] & 0xFFFFFFFF
    lens = torch.bincount(row, minlength=M)
    rank = (torch.arange(row.numel(), device=dev)
            - (torch.cumsum(lens, 0) - lens)[row])
    values = torch.zeros(total, dtype=torch.int32, device=dev)
    values[starts[row] + rank] = t.to(torch.int32)
    return Intersections(values, starts, lens.to(torch.int32), members)


def intersect(rows: torch.Tensor, ec_offsets: torch.Tensor,
              ec_transcripts: torch.Tensor) -> Intersections:
    """Each row's EC member lists intersected: rows int32 (M, C) of EC ids
    with SIG_PAD where there is none, the index's EC CSR (``ec_offsets``
    int32[E + 1], ``ec_transcripts`` int32[nnz], each EC's members sorted
    and unique). CUDA tensors take I2, a launch a call with rows, after
    one read-back of two numbers, the slots' total length (which sizes
    ``values``) and the summed list lengths; the results stay on the card
    for the caller to read. CPU tensors take :func:`plain`."""
    if all(t.device.type == "cpu" for t in (rows, ec_offsets,
                                            ec_transcripts)):
        return plain(rows, ec_offsets, ec_transcripts)
    _check(rows, ec_offsets, ec_transcripts)
    _build.require_cuda("intersect", rows, ec_offsets, ec_transcripts)
    M, C = rows.shape
    if M == 0:
        return _empty(rows)
    _, _, starts, totals = _slots(rows, ec_offsets)
    total, members = totals.tolist()
    dev = rows.device
    values = torch.empty(total, dtype=torch.int32, device=dev)
    lens = torch.empty(M, dtype=torch.int32, device=dev)
    fn = _build.function("seekmer_intersect", 7, 3)
    _build.check(fn(rows.data_ptr(), ec_offsets.data_ptr(),
                    ec_transcripts.data_ptr(), starts.data_ptr(),
                    values.data_ptr(), lens.data_ptr(), _build.stream_of(rows),
                    dev.index, M, C), "intersect")
    intersect.launches += 1
    return Intersections(values, starts, lens, members, True)


intersect.launches = 0
