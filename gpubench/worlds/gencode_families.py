"""gencode_families: a GENCODE-like transcriptome whose genes share
sequence, through gene families (recent paralogs) and processed
pseudogenes, as a human annotation's do.

- Base genes are drawn as ``simulate.isoform_transcriptome`` draws its
  genes: Poisson(``mean_exons``) exons (at least 2) of
  Poisson(``mean_exon_len``) bp (at least 30), random sequence, and
  Poisson(``mean_isoforms``) isoforms (at least 1), each an ordered subset
  of the exons that keeps each exon with probability 0.75, duplicates
  dropped.
- Paralogs: ``paralog_share`` of the genes that are not pseudogenes are
  copies of a base gene, at most ``max_family`` copies of one. A copy
  takes every exon of its parent with substitutions at a rate
  d ~ U(``paralog_divergence``), drawn once a copy, and draws its own
  isoforms over them.
- Processed pseudogenes: ``pseudogene_share`` of ``num_genes``. Each
  copies one spliced isoform of a gene that is not a pseudogene (a base
  gene or a paralog), cut at its 5' end by a fraction
  U(0, ``pseudogene_truncation``), with substitutions at a rate
  d ~ U(``pseudogene_divergence``): one single-exon transcript with a
  gene id of its own.

A substitution replaces a base by one of the other three, uniformly.
Every draw comes from the generator passed in, so a seed gives one world.

Parameters, keys of the configuration's ``world`` group: ``num_genes``,
``mean_isoforms``, ``mean_exons``, ``mean_exon_len`` as for
``isoform_transcriptome``. From a source: ``pseudogene_share``, GENCODE
44 counts ~14.7k pseudogenes among its 62,700 genes, ~23%
(gencodegenes.org/human/stats.html); processed pseudogenes are
retrotransposed copies of spliced mRNA, single-exon, the parent's exon
junctions kept, often 5'-truncated (Pei et al. 2012, Genome Biology
13:R51). Assumed, to be listed under ``assumed`` by the configuration
that uses them: ``pseudogene_truncation``, ``pseudogene_divergence`` and
``paralog_divergence`` (each [low, high]), ``paralog_share`` and
``max_family``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from gpubench.simulate import BASES


@dataclasses.dataclass
class Gene:
    exons: List[np.ndarray]  # each exon's codes (0-3); a pseudogene's one
    isoforms: List[Tuple[int, Tuple[int, ...]]]  # (number, exons kept)
    kind: str = "base"  # "base", "paralog" or "pseudogene"
    parent: int = -1  # the gene copied
    divergence: float = 0.0  # the copy's substitution rate
    source: Tuple[int, int] = (0, 0)  # a pseudogene's (isoform, 5' cut)

    def isoform_codes(self, i: int) -> np.ndarray:
        return np.concatenate([self.exons[e] for e in self.isoforms[i][1]])


def _isoforms(rng: np.random.Generator, n_exons: int,
              mean_isoforms: float) -> List[Tuple[int, Tuple[int, ...]]]:
    """``isoform_transcriptome``'s draw of a gene's isoforms."""
    out, seen = [], set()
    for i in range(max(1, int(rng.poisson(mean_isoforms)))):
        keep = rng.random(n_exons) < 0.75
        if not keep.any():
            keep[rng.integers(0, n_exons)] = True
        key = tuple(np.flatnonzero(keep).tolist())
        if key not in seen:
            seen.add(key)
            out.append((i, key))
    return out


def _substitute(rng: np.random.Generator, codes: np.ndarray,
                d: float) -> np.ndarray:
    """A copy of ``codes`` with each base replaced by another with
    probability ``d``."""
    out = codes.copy()
    hit = rng.random(out.size) < d
    out[hit] = (out[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
    return out


def _counts(p: dict) -> Tuple[int, int, int]:
    """(base genes, paralogs, pseudogenes) of parameters ``p``."""
    n = int(p["num_genes"])
    pseudo = int(round(p["pseudogene_share"] * n))
    para = int(round(p["paralog_share"] * (n - pseudo)))
    base = n - pseudo - para
    if base < 1 or para > base * int(p["max_family"]):
        raise ValueError(f"{base} base genes cannot parent {para} paralogs "
                         f"at most {p['max_family']} a gene")
    return base, para, pseudo


def draw(rng: np.random.Generator, p: dict) -> List[Gene]:
    """The world's genes: base genes, then paralogs, then pseudogenes."""
    n_base, n_para, n_pseudo = _counts(p)
    genes = []
    for _ in range(n_base):
        n_exons = max(2, int(rng.poisson(p["mean_exons"])))
        lens = np.maximum(rng.poisson(p["mean_exon_len"], size=n_exons), 30)
        exons = [rng.integers(0, 4, size=int(L)).astype(np.uint8)
                 for L in lens]
        genes.append(Gene(exons, _isoforms(rng, n_exons,
                                           p["mean_isoforms"])))
    slots = np.repeat(np.arange(n_base), int(p["max_family"]))
    for parent in rng.choice(slots, size=n_para, replace=False):
        d = float(rng.uniform(*p["paralog_divergence"]))
        exons = [_substitute(rng, e, d) for e in genes[parent].exons]
        genes.append(Gene(exons, _isoforms(rng, len(exons),
                                           p["mean_isoforms"]),
                          "paralog", int(parent), d))
    for _ in range(n_pseudo):
        parent = int(rng.integers(0, n_base + n_para))
        iso = int(rng.integers(0, len(genes[parent].isoforms)))
        mrna = genes[parent].isoform_codes(iso)
        cut = int(rng.uniform(0, p["pseudogene_truncation"]) * mrna.size)
        d = float(rng.uniform(*p["pseudogene_divergence"]))
        genes.append(Gene([_substitute(rng, mrna[cut:], d)], [(0, (0,))],
                          "pseudogene", parent, d, (iso, cut)))
    return genes


def make(rng: np.random.Generator, p: dict
         ) -> Tuple[List[str], List[str], List[str]]:
    """(transcript names, sequences, gene ids) of the world's genes."""
    names, seqs, gene_ids = [], [], []
    for g, gene in enumerate(draw(rng, p)):
        for i, (num, _) in enumerate(gene.isoforms):
            names.append(f"gene{g:06d}.iso{num}")
            seqs.append(BASES[gene.isoform_codes(i)].tobytes().decode())
            gene_ids.append(f"gene{g:06d}")
    return names, seqs, gene_ids
