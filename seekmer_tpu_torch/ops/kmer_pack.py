"""Canonical k-mer extraction over read batches, plain PyTorch.

Counterpart of ``seekmer_tpu/ops/kmer_pack.py``. Keys use the dual-lane
int32 layout of ``seekmer_tpu.encoding``: hi = first ``k//2`` bases, lo =
the rest, big-endian 2 bits per base; canonical = lexicographic minimum of
the forward and reverse-complement lanes. These are the plain versions that
CPU tensors use and that the pack kernel (``ops/pack_cuda.py``) is held
against.
"""

from __future__ import annotations

import torch

from seekmer_tpu.encoding import n_hi_lo


def unpack_codes_2bit(packed: torch.Tensor, bad: torch.Tensor,
                      L: int) -> torch.Tensor:
    """Inverse of ``encoding.pack_codes_2bit``.

    packed: uint8[B, (L+3)//4], base j at bits 2*(j%4) of byte j//4.
    bad: uint8[B, (L+7)//8], bit j%8 of byte j//8 marks invalid base j.
    Returns int32[B, L] codes (0..3 valid, 4 invalid).
    """
    B = packed.shape[0]
    p = packed.to(torch.int32)
    shifts = torch.arange(4, dtype=torch.int32, device=p.device) * 2
    c = ((p[:, :, None] >> shifts) & 3).reshape(B, -1)[:, :L]
    b = bad.to(torch.int32)
    bshifts = torch.arange(8, dtype=torch.int32, device=b.device)
    m = ((b[:, :, None] >> bshifts) & 1).reshape(B, -1)[:, :L]
    return torch.where(m == 1, torch.full_like(c, 4), c)


def pack_canonical(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mers of every window of a padded read batch.

    codes: int32/uint8[B, L] base codes (0..3 valid, >= 4 invalid or pad).
    lengths: int32[B] true read lengths.
    Returns (hi int32[B, P], lo int32[B, P], valid bool[B, P]) with
    P = L - k + 1; a window is valid when it lies inside the read and holds
    no invalid base.
    """
    B, L = codes.shape
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    P = L - k + 1
    n_hi, n_lo = n_hi_lo(k)
    c = codes.to(torch.int32)
    bad = c > 3
    safe = torch.where(bad, torch.zeros_like(c), c)
    dev = c.device
    hi_f = torch.zeros((B, P), dtype=torch.int32, device=dev)
    lo_f = torch.zeros_like(hi_f)
    hi_r = torch.zeros_like(hi_f)
    lo_r = torch.zeros_like(hi_f)
    any_bad = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for i in range(k):
        s = safe[:, i:i + P]
        any_bad |= bad[:, i:i + P]
        if i < n_hi:
            hi_f += s << (2 * (n_hi - 1 - i))
        else:
            lo_f += s << (2 * (n_lo - 1 - (i - n_hi)))
        j = k - 1 - i  # the reverse complement's base j reads position i
        rc = 3 - s
        if j < n_hi:
            hi_r += rc << (2 * (n_hi - 1 - j))
        else:
            lo_r += rc << (2 * (n_lo - 1 - (j - n_hi)))
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    valid = (pos + k <= lengths.to(torch.int32)[:, None]) & ~any_bad
    use_f = (hi_f < hi_r) | ((hi_f == hi_r) & (lo_f <= lo_r))
    return (torch.where(use_f, hi_f, hi_r), torch.where(use_f, lo_f, lo_r),
            valid)
