"""Synthetic transcriptomes and RNA-seq reads made from a seed, for tests,
smoke runs and benchmarks (no sequencing data ships with the repository):
the port's copy of ``seekmer_tpu/utils/simulate.py``. Both packages draw
equal worlds from one numpy generator seed.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import List, Optional, Tuple

import numpy as np

from ..encoding import seq_to_codes

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class SimulatedReads:
    reads1: List[str]
    reads2: Optional[List[str]]  # paired-end mate 2 (None for single-end)
    true_transcript: np.ndarray  # int32[N] source transcript per fragment


def random_transcriptome(
    rng: np.random.Generator,
    num_transcripts: int = 50,
    min_len: int = 200,
    max_len: int = 2000,
    shared_prefix_frac: float = 0.0,
) -> Tuple[List[str], List[str]]:
    """Random transcript sequences. ``shared_prefix_frac`` > 0 makes groups of
    transcripts share sequence (realistic isoform ambiguity for EC tests)."""
    names = [f"txp{i:05d}" for i in range(num_transcripts)]
    seqs: List[str] = []
    base_seq = None
    for i in range(num_transcripts):
        L = int(rng.integers(min_len, max_len + 1))
        seq = _BASES[rng.integers(0, 4, size=L)].tobytes().decode()
        if shared_prefix_frac > 0 and base_seq is not None and rng.random() < 0.5:
            n_shared = int(len(seq) * shared_prefix_frac)
            seq = base_seq[:n_shared] + seq[n_shared:]
        if i % 4 == 0:
            base_seq = seq
        seqs.append(seq)
    return names, seqs


def simulate_reads(
    rng: np.random.Generator,
    seqs: List[str],
    num_reads: int = 1000,
    read_len: int = 100,
    paired: bool = False,
    mean_frag: float = 250.0,
    sd_frag: float = 25.0,
    error_rate: float = 0.0,
    abundance: Optional[np.ndarray] = None,
) -> SimulatedReads:
    """Draw fragments from transcripts (prob ~ abundance * effective length)
    and emit error-injected reads; mate 2 is the reverse complement end."""
    T = len(seqs)
    lens = np.array([len(s) for s in seqs])
    frag = int(mean_frag) if paired else read_len
    eff = np.maximum(lens - frag + 1, 0).astype(np.float64)
    w = (abundance if abundance is not None else np.ones(T)) * eff
    if w.sum() == 0:
        raise ValueError("no transcript long enough for the fragment length")
    p = w / w.sum()

    tids = rng.choice(T, size=num_reads, p=p).astype(np.int32)
    reads1, reads2 = [], ([] if paired else None)
    comp = str.maketrans("ACGT", "TGCA")
    for t in tids:
        seq = seqs[t]
        if paired:
            flen = int(np.clip(rng.normal(mean_frag, sd_frag), read_len, len(seq)))
        else:
            flen = read_len
        start = int(rng.integers(0, len(seq) - flen + 1))
        fragment = seq[start : start + flen]
        r1 = fragment[:read_len]
        if error_rate > 0:
            r1 = _inject_errors(rng, r1, error_rate)
        reads1.append(r1)
        if paired:
            r2 = fragment[-read_len:][::-1].translate(comp)
            if error_rate > 0:
                r2 = _inject_errors(rng, r2, error_rate)
            reads2.append(r2)
    return SimulatedReads(reads1=reads1, reads2=reads2, true_transcript=tids)


def isoform_transcriptome(
    rng: np.random.Generator,
    num_genes: int = 1000,
    mean_isoforms: float = 3.0,
    mean_exons: int = 8,
    mean_exon_len: int = 180,
) -> Tuple[List[str], List[str], List[str]]:
    """Gene/isoform-structured transcriptome: each gene is a set of exons;
    isoforms are ordered exon subsets — the realistic shared-sequence
    structure that drives equivalence-class ambiguity at GENCODE scale
    (BASELINE config 2). Returns (names, seqs, gene_ids)."""
    names, seqs, genes = [], [], []
    for g in range(num_genes):
        n_exons = max(2, int(rng.poisson(mean_exons)))
        exon_lens = np.maximum(rng.poisson(mean_exon_len, size=n_exons), 30)
        exons = [
            _BASES[rng.integers(0, 4, size=int(L))].tobytes().decode()
            for L in exon_lens
        ]
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


def simulate_packed_batches(
    rng: np.random.Generator,
    seqs: List[str],
    num_batches: int,
    batch_size: int,
    read_len: int = 100,
    error_rate: float = 0.005,
    abundance: Optional[np.ndarray] = None,
):
    """Vectorized read simulation straight into packed device batches.

    Returns (codes uint8[num_batches, B, L], true_counts int64[T]). Used by
    benchmarks where per-read Python loops would dominate the wall clock.
    Reads are all forward-strand (canonicalization makes strand irrelevant
    to mapping).
    """
    T = len(seqs)
    lens = np.array([len(s) for s in seqs])
    eff = np.maximum(lens - read_len + 1, 0)
    w = (abundance if abundance is not None else np.ones(T)) * eff
    p = w / w.sum()

    concat = np.concatenate([seq_to_codes(s) for s in seqs])
    offsets = np.concatenate([[0], np.cumsum(lens)])[:-1]

    N = num_batches * batch_size
    tids = rng.choice(T, size=N, p=p).astype(np.int32)
    starts = (rng.random(N) * eff[tids]).astype(np.int64)
    pos = offsets[tids][:, None] + starts[:, None] + np.arange(read_len)
    codes = concat[pos].astype(np.uint8)
    if error_rate > 0:
        hit = rng.random(codes.shape) < error_rate
        codes[hit] = rng.integers(0, 4, size=int(hit.sum()), dtype=np.uint8)
    true_counts = np.bincount(tids, minlength=T).astype(np.int64)
    return codes.reshape(num_batches, batch_size, read_len), true_counts


def simulate_packed_pairs(
    rng: np.random.Generator,
    seqs: List[str],
    num_batches: int,
    batch_size: int,
    read_len: int = 100,
    mean_frag: float = 200.0,
    sd_frag: float = 20.0,
    error_rate: float = 0.005,
    abundance: Optional[np.ndarray] = None,
):
    """Vectorized PAIRED-fragment simulation into packed device batches.

    Both mates come from the same fragment (mate 2 = reverse complement of
    the fragment's far end), so paired-end signature/EC semantics are
    realistic — drawing two independent read streams instead gives every
    pair a unique union-signature, the degenerate worst case.

    Returns (codes1, codes2 uint8[num_batches, B, L], true_counts int64[T]).
    """
    T = len(seqs)
    lens = np.array([len(s) for s in seqs])
    min_frag = read_len
    eligible = lens >= min_frag
    w = (abundance if abundance is not None else np.ones(T)) * np.maximum(
        lens - mean_frag + 1, 0) * eligible
    if w.sum() == 0:
        w = eligible.astype(float)
    p = w / w.sum()

    concat = np.concatenate([seq_to_codes(s) for s in seqs])
    offsets = np.concatenate([[0], np.cumsum(lens)])[:-1]

    N = num_batches * batch_size
    tids = rng.choice(T, size=N, p=p).astype(np.int32)
    frag = np.clip(np.round(rng.normal(mean_frag, sd_frag, N)), min_frag,
                   lens[tids]).astype(np.int64)
    starts = (rng.random(N) * (lens[tids] - frag + 1)).astype(np.int64)
    base = offsets[tids] + starts
    pos1 = base[:, None] + np.arange(read_len)
    codes1 = concat[pos1].astype(np.uint8)
    # mate 2: last read_len bases of the fragment, reverse complemented
    pos2 = (base + frag)[:, None] - 1 - np.arange(read_len)
    c2 = concat[pos2].astype(np.uint8)
    codes2 = np.where(c2 < 4, 3 - c2.astype(np.int16), 4).astype(np.uint8)
    for codes in (codes1, codes2):
        if error_rate > 0:
            hit = rng.random(codes.shape) < error_rate
            codes[hit] = rng.integers(0, 4, size=int(hit.sum()),
                                      dtype=np.uint8)
    true_counts = np.bincount(tids, minlength=T).astype(np.int64)
    return (codes1.reshape(num_batches, batch_size, read_len),
            codes2.reshape(num_batches, batch_size, read_len), true_counts)


def _inject_errors(rng: np.random.Generator, read: str, rate: float) -> str:
    arr = np.frombuffer(read.encode(), dtype=np.uint8).copy()
    hit = rng.random(arr.size) < rate
    if hit.any():
        arr[hit] = _BASES[rng.integers(0, 4, size=int(hit.sum()))]
    return arr.tobytes().decode()


def write_fasta(path: str, names: List[str], seqs: List[str]) -> None:
    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{s}\n")


def write_fastq(path: str, reads: List[str], name_prefix: str = "read") -> None:
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@{name_prefix}{i}\n{r}\n+\n{'I' * len(r)}\n")
