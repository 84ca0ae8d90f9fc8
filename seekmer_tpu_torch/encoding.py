"""2-bit DNA encoding and canonical k-mer packing on the host (numpy): the
port's copy of ``seekmer_tpu/encoding.py``, with the functions the port
calls (``n_hi_lo``, ``seq_to_codes``, ``canonical_kmers``,
``pack_codes_2bit``, ``split_key``, ``join_key``).

A canonical k-mer (2k bits, k <= 29) is carried as two int32 lanes:

    hi = bases[0 : n_hi]   packed big-endian, 2 bits/base (n_hi = k // 2)
    lo = bases[n_hi : k]   packed big-endian, 2 bits/base (n_lo = k - n_hi)

and on the host as ``key64 = hi << (2*n_lo) | lo`` (uint64), whose numeric
order is the lexicographic order of (hi, lo). Base codes: A=0, C=1, G=2,
T=3, anything else 4 (invalid); the reverse complement of c is 3 - c.
"""

from __future__ import annotations

import numpy as np

INVALID = np.uint8(4)

# ASCII -> 2-bit code lookup (case-insensitive); everything else -> 4.
_CODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase


def n_hi_lo(k: int) -> tuple[int, int]:
    n_hi = k // 2
    return n_hi, k - n_hi


def seq_to_codes(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes in {0,1,2,3,4}."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[seq]


def canonical_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer windows of a code sequence, canonicalized.

    Returns (keys, valid): ``keys`` is uint64[P] with P = len(codes)-k+1
    (canonical 2k-bit key; undefined where invalid), ``valid`` is bool[P]
    marking windows containing no invalid base. Empty arrays if P <= 0.

    No (P, k) window matrix is materialized, so this scales to
    whole-transcriptome concatenations.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    P = codes.size - k + 1
    if P <= 0:
        return (np.empty(0, np.uint64), np.empty(0, bool))
    bad = codes > 3
    safe = np.where(bad, 0, codes).astype(np.uint64)

    def pack_windows(vals: np.ndarray) -> np.ndarray:
        # MSB-first double-and-add window pack: O(log k) passes through
        # two ping-pong scratch buffers
        n = vals.size
        buf0 = np.empty(n, np.uint64)
        buf1 = np.empty(n, np.uint64)

        def other(cur):
            return buf1 if cur is buf0 else buf0

        out = vals  # width 1; never written
        aw = 1
        for bit in bin(k)[3:]:  # binary digits of k after the MSB
            ln = n - 2 * aw + 1  # windows of width 2*aw
            dst = other(out)
            np.left_shift(out[:ln], np.uint64(2 * aw), out=dst[:ln])
            np.bitwise_or(dst[:ln], out[aw : aw + ln], out=dst[:ln])
            out, aw = dst, 2 * aw
            if bit == "1":
                ln = n - aw  # windows of width aw+1
                dst = other(out)
                np.left_shift(out[:ln], np.uint64(2), out=dst[:ln])
                np.bitwise_or(dst[:ln], vals[aw : aw + ln], out=dst[:ln])
                out, aw = dst, aw + 1
        return out[:P]

    fwd = pack_windows(safe)
    # rc window i = pack of complemented, reversed codes at mirror
    # position; materialize contiguously — reverse-strided views defeat
    # numpy vectorization inside pack_windows
    rev = np.ascontiguousarray((np.uint64(3) - safe)[::-1])
    rc = np.ascontiguousarray(pack_windows(rev)[::-1])
    # window validity via one cumulative sum over the bad mask
    cs = np.zeros(codes.size + 1, np.int64)
    np.cumsum(bad, out=cs[1:])
    anybad = (cs[k:] - cs[:-k]) > 0
    return np.minimum(fwd, rc), ~anybad


def pack_codes_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack uint8[B, L] base codes to 2 bits/base + an invalid bitmask.

    The upload layout of read batches: 0.375 bytes/base ((L+3)//4 code
    bytes + (L+7)//8 mask bytes) instead of 1. Base j of read b lives at
    bits 2*(j%4) of packed[b, j//4] (little-endian in byte); bit j%8 of
    bad[b, j//8] marks an invalid base (code > 3). Exact inverse:
    ops/kmer_pack.unpack_codes_2bit and the pack kernel (csrc/pack.cu).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    B, L = codes.shape
    L4 = (L + 3) // 4
    c = codes & np.uint8(3)
    if L % 4:
        c = np.pad(c, ((0, 0), (0, 4 * L4 - L)))
    c = c.reshape(B, L4, 4).astype(np.uint8)
    packed = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
              | (c[:, :, 3] << 6)).astype(np.uint8)
    bad = np.packbits(codes > 3, axis=1, bitorder="little")
    return packed, bad


def split_key(key64: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """uint64 key -> (hi, lo) int32 lanes (hi = top 2*n_hi bits)."""
    _, n_lo = n_hi_lo(k)
    hi = (key64 >> np.uint64(2 * n_lo)).astype(np.int32)
    lo = (key64 & np.uint64((1 << (2 * n_lo)) - 1)).astype(np.int32)
    return hi, lo


def join_key(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """(hi, lo) int32 lanes -> uint64 key: the inverse of ``split_key``."""
    _, n_lo = n_hi_lo(k)
    return (hi.astype(np.uint64) << np.uint64(2 * n_lo)) | lo.astype(np.uint64)
