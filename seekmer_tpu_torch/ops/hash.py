"""The 32-bit mixing hashes of ``seekmer_tpu.ops.hash`` on torch tensors.

torch's ``uint32`` supports neither ``>>`` nor ``+`` on the CPU, so uint32
arithmetic is emulated in int64 tensors holding values in ``[0, 2**32)``:
every result is masked back to 32 bits, and multiplications by a 32-bit
constant are split into 16-bit halves so no intermediate leaves int64.
Inputs may be int32 (reinterpreted as uint32) or int64 already in range;
outputs are int64 in ``[0, 2**32)``. The constants are the numpy ones of
``seekmer_tpu.ops.hash``, so host index build and device lookup agree bit
for bit.
"""

from __future__ import annotations

import torch

from seekmer_tpu.ops.hash import (
    _C1,
    _C2,
    _GOLDEN,
    _SIG_SEED1,
    _SIG_SEED2,
    _STASH_SALT,
)

MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (two's complement) or in-range int64 -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32) and a constant c < 2**32."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32."""
    h = h ^ (h >> 16)
    h = _mul(h, int(_C1))
    h = h ^ (h >> 13)
    h = _mul(h, int(_C2))
    return h ^ (h >> 16)


def hash_kmer(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Main-table slot hash of a (hi, lo) k-mer key."""
    return mix32(as_u32(hi) ^ mix32((as_u32(lo) + int(_GOLDEN)) & MASK32))


def hash_kmer_stash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Independent hash for the stash table."""
    return mix32(as_u32(lo) ^ mix32((as_u32(hi) + int(_STASH_SALT)) & MASK32))


def sig_fingerprint_init():
    """Initial (h1, h2) accumulators for signature fingerprinting."""
    return int(_SIG_SEED1), int(_SIG_SEED2)


def sig_fingerprint_step(h1, h2, ec_id):
    """Fold one EC id into the running 64-bit (h1, h2) fingerprint."""
    e = as_u32(ec_id)
    h1 = mix32(h1 ^ e)
    h2 = mix32((h2 + _mul(e, int(_GOLDEN))) & MASK32)
    return h1, h2


def sig_slot_hash(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Slot hash for the signature count table."""
    return mix32(as_u32(h1) ^ _mul(as_u32(h2), int(_C2)))
