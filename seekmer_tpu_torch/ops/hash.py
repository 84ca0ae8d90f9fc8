"""The 32-bit mixing hashes of the k-mer table and the signature table, in
two forms that agree bit for bit: numpy uint32 for the host (the index
build) and torch for the device (lookup, signatures). The port's copy of
``seekmer_tpu/ops/hash.py`` (murmur3 fmix32 and the same constants), whose
numpy forms are the ``*_np`` functions here.

torch's ``uint32`` supports neither ``>>`` nor ``+`` on the CPU, so the
torch forms emulate uint32 arithmetic in int64 tensors holding values in
``[0, 2**32)``: every result is masked back to 32 bits, and multiplications
by a 32-bit constant are split into 16-bit halves so no intermediate leaves
int64. Inputs may be int32 (reinterpreted as uint32) or int64 already in
range; outputs are int64 in ``[0, 2**32)``.
"""

from __future__ import annotations

import numpy as np
import torch

# murmur3 fmix32 constants
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)
_STASH_SALT = np.uint32(0x7FEB352D)
_SIG_SEED1 = np.uint32(0x2545F491)
_SIG_SEED2 = np.uint32(0x8F1BBCDC)

MASK32 = 0xFFFFFFFF


def mix32_np(h):
    """murmur3 fmix32 on numpy uint32; wrap-around is the defined
    behaviour, so numpy's overflow warning is silenced."""
    with np.errstate(over="ignore"):
        h = h ^ (h >> 16)
        h = h * _C1
        h = h ^ (h >> 13)
        h = h * _C2
        return h ^ (h >> 16)


def hash_kmer_np(hi, lo):
    """Main-table slot hash of (hi, lo) k-mer keys, numpy uint32."""
    with np.errstate(over="ignore"):
        return mix32_np(hi ^ mix32_np(lo + _GOLDEN))


def hash_kmer_stash_np(hi, lo):
    """Stash-table hash of (hi, lo) k-mer keys, numpy uint32."""
    with np.errstate(over="ignore"):
        return mix32_np(lo ^ mix32_np(hi + _STASH_SALT))


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
