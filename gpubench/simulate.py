"""Worlds and samples made from a seed: a frozen copy of the vectorised
generators of ``seekmer_tpu_torch/utils/simulate.py``
(``isoform_transcriptome``, the fragment draw of ``simulate_packed_pairs``)
with a vectorised FASTQ writer, and an expression profile that the
program's generator lacks. The benchmark keeps its own copy so that no
change to the program moves the data it is measured on.

A sample is drawn lane by lane, each lane from its own generator spawned
from the seed, so every seed gives the same sizes in the same layout and
only the reads differ.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# ASCII -> code (A C G T -> 0..3, anything else 4) and back
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i
ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def seq_to_codes(seq: str) -> np.ndarray:
    return _CODE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def isoform_transcriptome(rng: np.random.Generator, num_genes: int,
                          mean_isoforms: float = 3.0, mean_exons: int = 8,
                          mean_exon_len: int = 180
                          ) -> Tuple[List[str], List[str], List[str]]:
    """Genes as exon sets, isoforms as ordered exon subsets: the shared
    sequence that makes equivalence classes ambiguous at GENCODE scale.
    Returns (names, seqs, gene_ids). The draws are those of the program's
    generator, so one seed gives one world in both."""
    names, seqs, genes = [], [], []
    for g in range(num_genes):
        n_exons = max(2, int(rng.poisson(mean_exons)))
        exon_lens = np.maximum(rng.poisson(mean_exon_len, size=n_exons), 30)
        exons = [BASES[rng.integers(0, 4, size=int(L))].tobytes().decode()
                 for L in exon_lens]
        n_iso = max(1, int(rng.poisson(mean_isoforms)))
        seen = set()
        for i in range(n_iso):
            keep = rng.random(n_exons) < 0.75
            if not keep.any():
                keep[rng.integers(0, n_exons)] = True
            key = tuple(np.flatnonzero(keep).tolist())
            if key in seen:
                continue
            seen.add(key)
            names.append(f"gene{g:06d}.iso{i}")
            seqs.append("".join(e for e, k in zip(exons, keep) if k))
            genes.append(f"gene{g:06d}")
    return names, seqs, genes


def power_law_expression(rng: np.random.Generator, T: int, k: float,
                         x1: float, full_transcripts: int) -> np.ndarray:
    """Relative molecule counts of ``T`` transcripts under the Flux
    Simulator's expression model (Griebel et al. 2012): a transcript of
    rank x holds x^k exp(-(x / x1)(1 + x / x1)) molecules, ranks drawn as a
    random permutation. The world stands for a subsample of a transcriptome
    of ``full_transcripts``, so its ranks are spread over the full ranks
    (rank r of T at r * full_transcripts / T). Sums to 1."""
    x = (rng.permutation(T) + 1.0) * (full_transcripts / T)
    w = x ** k * np.exp(-(x / x1) * (1.0 + x / x1))
    return w / w.sum()


def draw_fragments(rng: np.random.Generator, concat: np.ndarray,
                   offsets: np.ndarray, lens: np.ndarray, n: int,
                   read_len: int, paired: bool, mean_frag: float,
                   sd_frag: float, error_rate: float,
                   expression: np.ndarray = None):
    """``n`` fragments drawn as ``simulate_packed_pairs`` draws them: a
    transcript with probability proportional to ``len - mean_frag + 1``
    (times its ``expression``, the relative molecule counts, where given)
    among those at least ``read_len`` long, a length ~ N(mean, sd) clipped
    to [read_len, len], a uniform start; mate 1 the fragment's first
    ``read_len`` bases, mate 2 the reverse complement of its last ones;
    each base replaced by a uniform one with probability ``error_rate``.
    A single-end read is mate 1. Returns (codes1, codes2 or None, tids)."""
    eligible = lens >= read_len
    w = np.maximum(lens - mean_frag + 1, 0) * eligible
    if expression is not None:
        w = w * expression
    if w.sum() == 0:
        w = eligible.astype(float)
    p = w / w.sum()
    tids = rng.choice(lens.size, size=n, p=p).astype(np.int32)
    frag = np.clip(np.round(rng.normal(mean_frag, sd_frag, n)), read_len,
                   lens[tids]).astype(np.int64)
    starts = (rng.random(n) * (lens[tids] - frag + 1)).astype(np.int64)
    base = offsets[tids] + starts
    codes1 = concat[base[:, None] + np.arange(read_len)]
    codes2 = None
    if paired:
        c2 = concat[(base + frag)[:, None] - 1 - np.arange(read_len)]
        codes2 = np.where(c2 < 4, 3 - c2.astype(np.int16), 4).astype(np.uint8)
    for codes in (codes1, codes2):
        if codes is not None and error_rate > 0:
            hit = rng.random(codes.shape) < error_rate
            codes[hit] = rng.integers(0, 4, size=int(hit.sum()),
                                      dtype=np.uint8)
    return codes1, codes2, tids


def draw_sample(seed: int, concat: np.ndarray, lens: np.ndarray,
                lanes: int, per_lane: int, read_len: int, paired: bool,
                mean_frag: float, sd_frag: float, error_rate: float,
                expression: np.ndarray = None):
    """A sample of ``lanes`` x ``per_lane`` fragments from ``seed``, lane by
    lane (one spawned generator a lane). Returns lists of per-lane codes1,
    codes2 (None entries for single-end)."""
    offsets = np.zeros(lens.size, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    children = np.random.SeedSequence(seed).spawn(lanes)
    c1s, c2s = [], []
    for ss in children:
        c1, c2, _ = draw_fragments(np.random.default_rng(ss), concat,
                                   offsets, lens, per_lane, read_len, paired,
                                   mean_frag, sd_frag, error_rate,
                                   expression)
        c1s.append(c1)
        c2s.append(c2)
    return c1s, c2s


def fastq_bytes(codes: np.ndarray, first: int = 0) -> np.ndarray:
    """FASTQ records of uint8[n, L] code rows as one uint8 array, built
    without a Python loop over reads: ``@r<9-digit index>``, the bases,
    ``+`` and a quality line of ``I``."""
    n, L = codes.shape
    digits = 9
    rec = 2 + digits + L + 3 + L + 1
    out = np.empty((n, rec), np.uint8)
    out[:, 0] = ord("@")
    out[:, 1] = ord("r")
    idx = np.arange(first, first + n, dtype=np.int64)
    for j in range(digits):
        out[:, 2 + j] = 48 + (idx // 10 ** (digits - 1 - j)) % 10
    c = 2 + digits
    out[:, c] = ord("\n")
    out[:, c + 1:c + 1 + L] = ASCII[np.minimum(codes, 4)]
    c += 1 + L
    out[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    out[:, c + 3:c + 3 + L] = ord("I")
    out[:, -1] = ord("\n")
    return out.reshape(-1)


def write_fastq(path: str, codes: np.ndarray, block: int = 1 << 16) -> int:
    """Write code rows as FASTQ; returns the bytes written."""
    written = 0
    with open(path, "wb") as fh:
        for s in range(0, codes.shape[0], block):
            buf = fastq_bytes(codes[s:s + block], s)
            fh.write(buf.tobytes())
            written += buf.size
    return written
