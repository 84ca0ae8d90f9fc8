"""K1: canonical k-mer packing from 2-bit packed reads (``csrc/pack.cu``).

Replaces ``seekmer_tpu/ops/pack_pallas.py`` ``_pack_kernel`` (through
``pack_canonical_pallas``) with ``ops/kmer_pack.unpack_codes_2bit`` fused
in: the kernel reads what the main path uploads (2-bit codes and the
invalid-base bitmask) and never writes the unpacked code plane. It is
bound by its per-window loop of k base reads, not by the 9 bytes it writes
per window; see the source note.
"""

from __future__ import annotations

import torch

from . import _build
from .kmer_pack import pack_canonical, unpack_codes_2bit


def plain(packed: torch.Tensor, bad: torch.Tensor, lengths: torch.Tensor,
          L: int, k: int):
    """The plain PyTorch version: unpack, then pack."""
    return pack_canonical(unpack_codes_2bit(packed, bad, L), lengths, k)


def pack_canonical_2bit(packed: torch.Tensor, bad: torch.Tensor,
                        lengths: torch.Tensor, L: int, k: int):
    """Canonical k-mers of every window of a 2-bit packed read batch.

    packed uint8[B, (L+3)//4], bad uint8[B, (L+7)//8], lengths int32[B];
    returns (hi int32[B, P], lo int32[B, P], valid bool[B, P]),
    P = L - k + 1, equal to ``kmer_pack.pack_canonical`` of the unpacked
    codes. CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if packed.device.type == "cpu":
        return plain(packed, bad, lengths, L, k)
    B = packed.shape[0]
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    if packed.dtype != torch.uint8 or bad.dtype != torch.uint8:
        raise ValueError("packed and bad must be uint8")
    if packed.shape != (B, (L + 3) // 4) or bad.shape != (B, (L + 7) // 8):
        raise ValueError(f"packed/bad shapes {tuple(packed.shape)}, "
                         f"{tuple(bad.shape)} do not fit L={L}")
    lengths = lengths.to(torch.int32)
    _build.require_cuda("pack_canonical_2bit", packed, bad, lengths)
    P = L - k + 1
    hi = torch.empty((B, P), dtype=torch.int32, device=packed.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((B, P), dtype=torch.bool, device=packed.device)
    fn = _build.function("seekmer_pack_canonical", 7, 4)
    _build.check(fn(packed.data_ptr(), bad.data_ptr(), lengths.data_ptr(),
                    hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                    _build.stream_of(packed), packed.device.index, B, L, k),
                 "pack")
    pack_canonical_2bit.launches += 1
    return hi, lo, valid


pack_canonical_2bit.launches = 0
