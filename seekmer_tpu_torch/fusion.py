"""Fusion-transcript candidates from discordant read pairs: the port's
copy of ``seekmer_tpu/fusion.py`` (``FusionCandidate``, ``FusionReport``,
``_intersect_members``, ``_split_mate``, ``call_fusions``,
``detect_fusions_files``), pure numpy apart from its imports, which are the
port's ``MapResult``, ``Mapper``, ``batch_read_pairs_native`` and
``prefetch``.

The mapper runs in fusion mode (``MapConfig.fusion_pairs``: each mate's EC
signature kept side by side, ``map/driver.py``); each distinct pair
signature is then resolved once on the host:

  mate transcript sets  m1 = ∩ ECs(mate1),  m2 = ∩ ECs(mate2)
  m1 ∩ m2 != {}                      -> concordant (normal pair)
  genes(m1) ∩ genes(m2) != {}        -> same-gene discordance (isoforms,
                                        read-throughs): not a fusion
  |genes(m1)| == |genes(m2)| == 1    -> fusion candidate (geneA, geneB)
  otherwise                          -> ambiguous (multi-gene mates)

A mate that spans the fusion junction hits ECs of both genes (the
junction-crossing windows themselves miss), so its EC intersection is
empty. When such a mate's ECs 2-color cleanly by gene (every EC
single-gene, exactly two genes, each gene's ECs with a nonempty
intersection) and its partner is consistent (maps into one of the two
genes, splits over the same pair, or has no hits), it is called a
split read for that gene pair. Candidates report discordant-pair and
split-read support separately.

``detect_fusions_files`` takes ``device`` as every entry point of the port
does: the card unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Tuple

import numpy as np

from .index.store import KMerIndex
from .map.driver import MapResult

log = logging.getLogger(__name__)

_PAD = np.int32(0x7FFFFFFF)


@dataclasses.dataclass
class FusionCandidate:
    gene1: str
    gene2: str
    count: int  # discordant-pair support
    transcripts1: List[str]
    transcripts2: List[str]
    split_reads: int = 0  # junction-spanning mate support


@dataclasses.dataclass
class FusionReport:
    candidates: List[FusionCandidate]
    pairs_total: int
    concordant: int
    same_gene_discordant: int
    ambiguous: int
    unresolved: int  # a mate's EC intersection was empty (and not a split)
    split_reads: int = 0  # total junction-spanning mates called


def _intersect_members(index: KMerIndex, ecs: np.ndarray) -> np.ndarray:
    members = index.ec_members(int(ecs[0]))
    for ec in ecs[1:]:
        members = np.intersect1d(members, index.ec_members(int(ec)),
                                 assume_unique=True)
        if members.size == 0:
            break
    return members


def _split_mate(index: KMerIndex, genes: np.ndarray, ecs: np.ndarray):
    """Junction-spanning mate: its ECs 2-color cleanly by gene.

    Returns [(geneA, membersA), (geneB, membersB)] (key-sorted) or None
    when the EC set is not a clean two-gene split (multi-gene ECs, more
    or fewer than two genes, or an internally inconsistent gene group).
    """
    groups: Dict[str, list] = {}
    for ec in ecs:
        g = np.unique(genes[index.ec_members(int(ec))])
        if g.size != 1:
            return None
        groups.setdefault(str(g[0]), []).append(int(ec))
    if len(groups) != 2:
        return None
    out = []
    for g, ec_list in sorted(groups.items()):
        m = _intersect_members(index, np.asarray(ec_list))
        if m.size == 0:
            return None
        out.append((g, m))
    return out


def call_fusions(result: MapResult, index: KMerIndex, max_ecs: int,
                 min_count: int = 2) -> FusionReport:
    """Resolve pair signatures (mapper run with fusion_pairs=True) into
    gene-pair fusion candidates with discordant-pair and split-read
    support counts. Acceptance: count + split_reads >= min_count."""
    genes = index.genes if index.genes is not None else index.names
    agg: Dict[Tuple[str, str], int] = {}
    splits: Dict[Tuple[str, str], int] = {}
    txps: Dict[Tuple[str, str], Tuple[set, set]] = {}
    concordant = same_gene = ambiguous = unresolved = 0
    split_total = 0

    def add_members(key, gene_members):
        t = txps.setdefault(key, (set(), set()))
        for g, m in gene_members:
            t[0 if g == key[0] else 1].update(index.names[m].tolist())

    def partner_gene(m):
        """Single gene a resolved mate maps to, else None."""
        g = np.unique(genes[m])
        return str(g[0]) if g.size == 1 else None

    for row, n in zip(result.sigs, result.sig_counts):
        n = int(n)
        e1 = row[:max_ecs]
        e2 = row[max_ecs:]
        e1 = e1[e1 != _PAD]
        e2 = e2[e2 != _PAD]
        if e1.size == 0 and e2.size == 0:
            unresolved += n
            continue
        m1 = _intersect_members(index, e1) if e1.size else np.empty(0, int)
        m2 = _intersect_members(index, e2) if e2.size else np.empty(0, int)

        if (e1.size and m1.size == 0) or (e2.size and m2.size == 0):
            # a mate with hits but an EMPTY intersection: try the
            # split-read call on each such mate; the partner must be
            # consistent (maps into one of the two genes, splits over
            # the same pair, or has no hits)
            pair_keys = []
            gene_members = []
            consistent = True
            for e, m, other_m in ((e1, m1, m2), (e2, m2, m1)):
                if not e.size or m.size:
                    continue
                sp = _split_mate(index, genes, e)
                if sp is None:
                    consistent = False
                    break
                key = (sp[0][0], sp[1][0])
                if other_m.size:
                    pg = partner_gene(other_m)
                    if pg is None or pg not in key:
                        consistent = False
                        break
                pair_keys.append(key)
                gene_members.extend(sp)
            if not consistent or not pair_keys or (
                    len(pair_keys) == 2 and pair_keys[0] != pair_keys[1]):
                unresolved += n
                continue
            key = pair_keys[0]
            n_split = n * len(pair_keys)  # both mates spanning counts twice
            splits[key] = splits.get(key, 0) + n_split
            split_total += n_split
            add_members(key, gene_members)
            continue

        if e1.size == 0 or e2.size == 0:
            # hit-less wildcard mate, partner resolves normally: no
            # pair-level discordance signal either way
            unresolved += n
            continue

        # both mates resolve: the discordant-PAIR logic
        if np.intersect1d(m1, m2, assume_unique=True).size:
            concordant += n
            continue
        g1 = np.unique(genes[m1])
        g2 = np.unique(genes[m2])
        if np.intersect1d(g1, g2).size:
            same_gene += n
            continue
        if g1.size != 1 or g2.size != 1:
            ambiguous += n
            continue
        key = tuple(sorted((str(g1[0]), str(g2[0]))))
        agg[key] = agg.get(key, 0) + n
        add_members(key, [(str(g1[0]), m1), (str(g2[0]), m2)])

    keys = set(agg) | set(splits)
    candidates = [
        FusionCandidate(
            gene1=k[0], gene2=k[1], count=agg.get(k, 0),
            transcripts1=sorted(txps[k][0]),
            transcripts2=sorted(txps[k][1]),
            split_reads=splits.get(k, 0))
        for k in keys
        if agg.get(k, 0) + splits.get(k, 0) >= min_count
    ]
    candidates.sort(
        key=lambda c: (-(c.count + c.split_reads), c.gene1, c.gene2))
    dropped = sum(agg.get(k, 0) for k in keys
                  if agg.get(k, 0) + splits.get(k, 0) < min_count)
    report = FusionReport(
        candidates=candidates,
        pairs_total=result.total_reads,
        concordant=concordant,
        same_gene_discordant=same_gene,
        ambiguous=ambiguous + dropped,
        unresolved=unresolved + (result.total_reads - result.mapped
                                 - result.overflow),
        split_reads=split_total,
    )
    log.info(
        "fusion calling: %d candidates (pair+split support >= %d) from %d "
        "pairs (%d discordant-pair-supported, %d split reads, "
        "%d concordant, %d same-gene, %d ambiguous, %d unresolved)",
        len(candidates), min_count, report.pairs_total,
        sum(c.count for c in candidates), split_total, report.concordant,
        report.same_gene_discordant, report.ambiguous, report.unresolved)
    return report


def detect_fusions_files(index: KMerIndex, fastq_paths: List[str],
                         mate_paths: List[str], cfg=None,
                         min_count: int = 2, device="cuda") -> FusionReport:
    """End-to-end fusion detection over paired FASTQ files on ``device``."""
    from .config import MapConfig
    from .io.fastq import batch_read_pairs_native
    from .map.driver import Mapper
    from .utils.prefetch import device_put_batches, prefetch

    if cfg is None:
        cfg = MapConfig()
    cfg = dataclasses.replace(cfg, paired_end=True, fusion_pairs=True)
    mapper = Mapper(index, cfg, device=device)
    batches = prefetch(device_put_batches(
        batch_read_pairs_native(fastq_paths, mate_paths, cfg),
        mapper.device), depth=4)
    result = mapper.run(batches)
    return call_fusions(result, index, cfg.max_ecs_per_read,
                        min_count=min_count)
