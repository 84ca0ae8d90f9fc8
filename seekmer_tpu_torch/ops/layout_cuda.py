"""I1: the bucketized k-mer table laid out in place (``csrc/layout.cu``).

Replaces no TPU kernel: the JAX package lays the table out on the host
(``seekmer_tpu/ops/probe.py`` ``device_table_layout``, copied as
``ops/probe.device_table_layout``) and uploads the result. On the card the
raw (S, 4) rows ``[hi, lo, ec, aux]`` are uploaded as they are and each
bucket row of ``bucket`` slots is rewritten, in the same bytes, as the
slab row ``[hi x G | lo x G | ecaux x G | meta x G]`` that K2, K5-K7 and
the plain lookups read, bit for bit ``device_table_layout``'s. The kernel
is bound by the bytes: one read and one write of the table, a coalesced
16-byte load a slot and four coalesced stores a bucket at G = 32. It also
takes the largest EC id of the occupied slots, read back once a call, so
the packed-lane limit (``MAX_EC_ID``) is checked without a host pass over
the table.

CPU tensors take :func:`plain`, the same in place rewrite in PyTorch.
"""

from __future__ import annotations

import torch

from . import _build
from .probe import AUX_BITS, AUX_MASK, EMPTY, MAX_EC_ID


def _check_ec_max(ec_max: int) -> None:
    """Raise, as ``device_table_layout`` does, when the largest EC id of an
    occupied slot does not fit the packed lane."""
    if ec_max > MAX_EC_ID:
        raise ValueError(
            f"EC id {ec_max} exceeds the packed-lane limit {MAX_EC_ID} "
            f"(ecaux = ec << {AUX_BITS} | aux)")


def _check_raw(t: torch.Tensor, bucket: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 4:
        raise ValueError(f"raw tables are int32 (S, 4), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[0] % bucket:
        raise ValueError(f"{t.shape[0]} slots are not whole buckets of "
                         f"{bucket}")


def plain(table: torch.Tensor, bucket: int) -> torch.Tensor:
    """A CPU tensor's rows laid out in place; returns its
    (S / bucket, 4 * bucket) view. Raises before writing when an EC id does
    not fit the packed lane."""
    _check_raw(table, bucket)
    rows = table.view(-1, bucket, 4)
    hi, lo, ec, aux = rows.unbind(2)
    occ = hi != EMPTY
    if bool(occ.any()):
        _check_ec_max(int(ec[occ].max()))
    ecaux = torch.where(occ, (ec << AUX_BITS) | aux.clamp(0, AUX_MASK),
                        EMPTY)
    meta = occ.all(dim=1, keepdim=True).expand_as(hi).to(torch.int32)
    out = table.view(-1, 4 * bucket)
    out.copy_(torch.cat([hi, lo, ecaux, meta], dim=1))
    return out


def layout_table(*tables: torch.Tensor, bucket: int):
    """Each raw int32 (S, 4) table laid out in place; returns their
    (S / bucket, 4 * bucket) views, equal to ``device_table_layout``'s.
    CUDA tensors take the kernel, a launch a table, and one read-back of
    the largest EC id for them all (the call's one sync); a table whose EC
    ids do not fit the packed lane raises ``ValueError`` after it was
    rewritten. CPU tensors take :func:`plain`."""
    if not 1 <= bucket <= 32 or bucket & (bucket - 1):
        raise ValueError(f"the layout kernel takes buckets of a power of two "
                         f"<= 32 slots, got {bucket}")
    if all(t.device.type == "cpu" for t in tables):
        return tuple(plain(t, bucket) for t in tables)
    for t in tables:
        _check_raw(t, bucket)
    _build.require_cuda("layout_table", *tables)
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("tables must start on a 16-byte boundary (the "
                         "kernel reads a slot as one 16-byte vector)")
    dev = tables[0].device
    ec_max = torch.full((1,), torch.iinfo(torch.int32).min,
                        dtype=torch.int32, device=dev)
    fn = _build.function("seekmer_layout", 3, 4)
    for t in tables:
        _build.check(fn(t.data_ptr(), ec_max.data_ptr(),
                        _build.stream_of(t), dev.index, t.shape[0], bucket,
                        AUX_BITS), "layout")
        layout_table.launches += t.shape[0] > 0
    _check_ec_max(int(ec_max.item()))
    return tuple(t.view(-1, 4 * bucket) for t in tables)


layout_table.launches = 0
