"""K1: canonical k-mer packing from 2-bit packed reads (``csrc/pack.cu``).

Replaces ``seekmer_tpu/ops/pack_pallas.py`` ``_pack_kernel`` (through
``pack_canonical_pallas``) with ``ops/kmer_pack.unpack_codes_2bit`` fused
in: the kernel reads what the main path uploads (2-bit codes and the
invalid-base bitmask) and never writes the unpacked code plane. A block
stages its rows' bytes in shared memory and computes each window in closed
form (a funnel shift of the row's bits, the bad bases cleared, a bit
reversal for the forward strand, a complement for the reverse), with no
loop over k; it is bound by the 9 bytes it writes per window. See the
source note.

Paired batches pass ``out`` and ``offset``: each mate writes its windows
into columns ``[offset, offset + P)`` of one ``(B, W)`` output, so the map
step joins the mates without a concatenation (``pack_mates``).
"""

from __future__ import annotations

import torch

from . import _build
from .kmer_pack import pack_canonical, unpack_codes_2bit


def plain(packed: torch.Tensor, bad: torch.Tensor, lengths: torch.Tensor,
          L: int, k: int, out=None, offset: int = 0):
    """The plain PyTorch version: unpack, then pack; with ``out``, the
    result fills columns ``[offset, offset + P)`` of ``out``, which is
    returned."""
    res = pack_canonical(unpack_codes_2bit(packed, bad, L), lengths, k)
    if out is None:
        return res
    _check_out(out, packed.shape[0], L - k + 1, offset, packed.device)
    for o, r in zip(out, res):
        o[:, offset:offset + r.shape[1]] = r
    return out


def _check_out(out, B: int, P: int, offset: int, device) -> None:
    hi, lo, valid = out
    W = hi.shape[1] if hi.dim() == 2 else -1
    if (hi.shape != (B, W) or lo.shape != (B, W) or valid.shape != (B, W)
            or not 0 <= offset <= W - P):
        raise ValueError(f"out shapes {[tuple(t.shape) for t in out]} do not "
                         f"hold {P} windows of {B} rows at column {offset}")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise ValueError("out must be (int32, int32, bool)")
    if any(t.device != device for t in out):
        raise ValueError(f"out must be on {device}")


def pack_canonical_2bit(packed: torch.Tensor, bad: torch.Tensor,
                        lengths: torch.Tensor, L: int, k: int, out=None,
                        offset: int = 0):
    """Canonical k-mers of every window of a 2-bit packed read batch.

    packed uint8[B, (L+3)//4], bad uint8[B, (L+7)//8], lengths int32[B];
    returns (hi int32[B, P], lo int32[B, P], valid bool[B, P]),
    P = L - k + 1, equal to ``kmer_pack.pack_canonical`` of the unpacked
    codes. With ``out`` = (hi, lo, valid) of shape (B, W), the windows go
    into columns ``[offset, offset + P)`` of ``out``, which is returned.
    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if packed.device.type == "cpu":
        return plain(packed, bad, lengths, L, k, out, offset)
    B = packed.shape[0]
    if not 1 <= k <= 29 or L < k:
        raise ValueError(f"padded length {L}, k={k}: need 1 <= k <= 29, "
                         f"k <= L")
    if packed.dtype != torch.uint8 or bad.dtype != torch.uint8:
        raise ValueError("packed and bad must be uint8")
    if packed.shape != (B, (L + 3) // 4) or bad.shape != (B, (L + 7) // 8):
        raise ValueError(f"packed/bad shapes {tuple(packed.shape)}, "
                         f"{tuple(bad.shape)} do not fit L={L}")
    lengths = lengths.to(torch.int32)
    P = L - k + 1
    if out is None:
        hi = torch.empty((B, P), dtype=torch.int32, device=packed.device)
        out = (hi, torch.empty_like(hi),
               torch.empty((B, P), dtype=torch.bool, device=packed.device))
    else:
        _check_out(out, B, P, offset, packed.device)
    _build.require_cuda("pack_canonical_2bit", packed, bad, lengths, *out)
    hi, lo, valid = out
    fn = _build.function("seekmer_pack_canonical", 7, 6)
    _build.check(fn(packed.data_ptr(), bad.data_ptr(), lengths.data_ptr(),
                    hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                    _build.stream_of(packed), packed.device.index, B, L, k,
                    hi.shape[1], offset),
                 "pack")
    pack_canonical_2bit.launches += 1
    return out


pack_canonical_2bit.launches = 0


def pack_mates(mates, L: int, k: int):
    """K1 on each mate's (packed, bad, lengths), side by side in one
    (B, len(mates) P) output; a single mate gets its own."""
    if len(mates) == 1:
        return pack_canonical_2bit(*mates[0], L, k)
    dev, B, P = mates[0][0].device, mates[0][0].shape[0], max(L - k + 1, 0)
    shape = (B, len(mates) * P)
    out = (torch.empty(shape, dtype=torch.int32, device=dev),
           torch.empty(shape, dtype=torch.int32, device=dev),
           torch.empty(shape, dtype=torch.bool, device=dev))
    for g, m in enumerate(mates):
        pack_canonical_2bit(*m, L, k, out=out, offset=g * P)
    return out
