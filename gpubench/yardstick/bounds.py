"""The least time the card could take for the work of K2 (the k-mer
lookup) and A3 (the CSR EM fixed point), from the work's shapes: frozen
copies of ``chip_smoke.py``'s ``check_lookup`` byte count and
``csr_bound``, with the program-made parts replaced by what any
implementation has to read.

K2 reads each lane's (hi, lo, valid) and writes its (EC, aux): 17 bytes a
lane of the batch's (B, 2P) window grid, P = pad - k + 1 with reads padded
to a multiple of 32; it reads the key slab (4 bytes a slot, ``bucket``
slots) of every distinct home bucket a valid key hashes to, and the two
32-byte sectors (key low half, EC) of every distinct key it finds. Home
buckets are counted as a uniform hash spreads the batch's distinct valid
keys over the table's buckets: n (1 - (1 - 1/n)^K).

A3, ``its`` iterations of EM over a CSR of E classes, T transcripts and
nnz entries at B replicates, the convergence test every ``C``: the counts
(E B) and the start and the result (2 T B) once, the scale (T) and the
CSR's offsets and both index arrays (4 (E + T + 2) + 8 nnz bytes) once;
4 operations an entry and replicate an iteration (the E-phase's sum, the
M-phase's product, quotient and sum), one a transcript and replicate (its
weight), and 5 a transcript and replicate a test. The bound is the larger
of the bytes at the HBM peak and the operations at the FP32 peak.
"""

from __future__ import annotations

import math

from . import peaks

K2_LANE_BYTES = 17
SECTOR = 32


def padded(read_len: int, bucket: int = 32) -> int:
    return ((read_len + bucket - 1) // bucket) * bucket


def k2_bytes(batch_rows: int, mates: int, read_len: int, k: int,
             distinct_valid: int, distinct_found: int, n_buckets: int,
             bucket: int) -> float:
    P = max(padded(read_len) - k + 1, 0)
    lanes = batch_rows * mates * P
    rows = n_buckets * -math.expm1(distinct_valid * math.log1p(-1 / n_buckets))
    return (lanes * K2_LANE_BYTES + rows * 4 * bucket
            + distinct_found * 2 * SECTOR)


def k2_seconds(nbytes: float) -> float:
    return nbytes / peaks.HBM_BYTES_S


def a3_seconds(E: int, T: int, nnz: int, B: int, its: int, C: int = 16,
               elem: int = 4) -> float:
    moved = elem * (2 * T * B + E * B + T) + 4 * (E + T + 2) + 8 * nnz
    ops = its * (4.0 * nnz + T) * B + -(-its // C) * 5.0 * T * B
    flops = peaks.FP64_FLOPS if elem == 8 else peaks.FP32_FLOPS
    return max(moved / peaks.HBM_BYTES_S, ops / flops)
