"""The port's ``Quantifier.quantify_files`` on a small GENCODE-like world
with gene families and processed pseudogenes
(``gpubench/worlds/gencode_families.py``, the ``gencode_paralog_pe100``
configuration's parameters at 120 genes), held against the benchmark's
plain reference (``gpubench/reference/``, plain PyTorch) on the CPU:

- the classes and their fragment counts, and ``mapped``, exactly;
- est_counts against float64 EM for the program's own iterations, within
  the configuration's ``est_gap`` limit (``gpubench/check.py``);
- the counters ``complex_fragments`` (more than ``max_ecs_per_read``
  classes), ``empty_intersection_fragments`` and ``multi_gene_classes``
  exactly against the same counts taken from the reference's
  ``signatures`` and ``resolve`` and the world's own gene ids.

A cap of 7 classes a fragment, so that complex fragments occur at this
size; single-end (1x75, fragment length given) and paired (2x100, FLD
estimated)."""

import re

import numpy as np
import pytest
import torch

from gpubench import check, manifest, simulate, world
from gpubench.reference import kmers
from seekmer_tpu_torch.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu_torch.index.store import KMerIndex
from seekmer_tpu_torch.models import quantifier
from seekmer_tpu_torch.models.quantifier import Quantifier

CAP = 7
LANES, PER_LANE = 2, 4096
SEED = 2**31 + 23


def _config(paired: bool) -> dict:
    """The families configuration, cut to a CPU test: 120 genes, small
    batches and table, EM's cap at 2,000 steps, no bootstrap; single-end
    takes ``gencode_se75``'s reads and EM settings."""
    cfg = manifest.load_config("gencode_paralog_pe100")
    if not paired:
        se = manifest.load_config("gencode_se75")
        cfg.update(reads=se["reads"], map=se["map"], em=se["em"])
    cfg["world"].update(num_genes=120)
    # the real profile's ranks spread so that a tiny world keeps most of
    # its transcripts expressed, as the full one does
    cfg["world"]["expression"]["full_transcripts"] = 20000
    cfg["map"].update(batch_size=4096, sig_table_bits=16,
                      max_ecs_per_read=CAP)
    cfg["em"].update(max_iters=2000, bootstrap_samples=0)
    return cfg


def _gene_ids(wdir) -> np.ndarray:
    """Each transcript's gene, in the world's order, from its GTF."""
    genes = re.findall(r'gene_id "([^"]*)"',
                       (wdir / "transcripts.gtf").read_text())
    return np.unique(np.asarray(genes), return_inverse=True)[1]


def _complex_fragments(tab, lanes1, lanes2, k: int) -> int:
    """The fragments with more than CAP distinct classes over both mates'
    windows, as ``kmers.map_reads`` forms a fragment's classes."""
    n = 0
    for i, c1 in enumerate(lanes1):
        rows = []
        for c in [c1] + ([lanes2[i]] if lanes2 is not None else []):
            keys, valid = kmers.windows(torch.from_numpy(c), k)
            r = kmers.lookup(tab, keys, valid)
            rows.append(torch.where(r >= 0, tab["cls"][r.clamp(min=0)], -1))
        sig, mapped = kmers.signatures(torch.cat(rows, dim=1), CAP)
        n += int((~mapped & (sig[:, 0] != kmers.BIG)).sum())
    return n


@pytest.fixture(scope="module", params=[False, True],
                ids=["single", "paired"])
def quantified(request, tmp_path_factory):
    """The program's result and EC table and the reference's answer on one
    sample of the small families world."""
    paired = request.param
    tmp = tmp_path_factory.mktemp("families")
    cfg = _config(paired)
    dev = torch.device("cpu")
    wd = world.ensure(cfg, tmp / "cache", dev, lambda m: None)
    mix = {"lanes": LANES, "fragments_per_lane": PER_LANE}
    lanes1, lanes2 = world.sample(wd, cfg, mix, SEED)
    r1 = [str(tmp / f"lane{i}_1.fq") for i in range(LANES)]
    r2 = [str(tmp / f"lane{i}_2.fq") for i in range(LANES)]
    for i in range(LANES):
        simulate.write_fastq(r1[i], lanes1[i])
        if paired:
            simulate.write_fastq(r2[i], lanes2[i])

    seen = {}
    real = quantifier.build_ec_table

    def spy(member_lists, counts, *a, **kw):
        seen["ecs"] = {tuple(m.tolist()): float(c)
                       for m, c in zip(member_lists, counts)}
        return real(member_lists, counts, *a, **kw)

    index = KMerIndex.load(str(wd.index))
    pcfg = PipelineConfig().replace(map=MapConfig(**cfg["map"]),
                                    em=EMConfig(**cfg["em"]))
    quantifier.build_ec_table = spy
    try:
        res = Quantifier(index, pcfg, device="cpu").quantify_files(
            r1, mate_paths=r2 if paired else None)
    finally:
        quantifier.build_ec_table = real

    table = world.load_table(wd, dev)
    to = torch.from_numpy
    ref = check.Reference(table, [to(a) for a in lanes1],
                          [to(a) for a in lanes2] if paired else None,
                          wd.lengths, cfg, dev)
    m = kmers.map_reads(table, [to(a) for a in lanes1],
                        [to(a) for a in lanes2] if paired else None,
                        cfg["index"]["kmer_length"], CAP)
    ec_off, ec_tids, ec_counts, dropped = kmers.resolve(
        table, m["sigs"], m["sig_counts"], wd.lengths.size)
    return {"res": res, "ecs": seen["ecs"], "ref": ref, "cfg": cfg,
            "ec_off": ec_off, "ec_tids": ec_tids, "ec_counts": ec_counts,
            "dropped": dropped,
            "genes": _gene_ids(world.ensure_world(cfg["world"], tmp / "cache",
                                                  lambda m: None)[0]),
            "complex": _complex_fragments(
                table, lanes1, lanes2 if paired else None,
                cfg["index"]["kmer_length"])}


def test_classes_and_mapped_exact(quantified):
    q = quantified
    off, tids = q["ec_off"].tolist(), q["ec_tids"].tolist()
    want = {tuple(tids[off[e]:off[e + 1]]): float(c)
            for e, c in enumerate(q["ec_counts"].tolist())}
    assert q["ecs"] == want
    assert q["res"].mapped == q["ref"].mapped == int(q["ec_counts"].sum())
    assert q["res"].total_reads == q["ref"].total == LANES * PER_LANE


def test_est_counts_against_float64_em(quantified):
    q = quantified
    res = q["res"]
    out = {"total": res.total_reads, "mapped": res.mapped,
           "est": res.est_counts, "iters": res.em_iterations, "boot": None,
           "fld": (None if res.fld_mean is None else
                   (res.fld_mean, res.fld_sd, res.fld_samples)),
           "rows": res.est_counts.size}
    nums = check.numbers(out, q["ref"])
    assert nums["est_gap"] <= q["cfg"]["limits"]["est_gap"], nums
    assert nums["mapped"] == nums["fragments"] == nums["outputs"] == 0


def test_unmapped_split_exact(quantified):
    """complex_fragments and empty_intersection_fragments as the
    reference counts them, and both present at this size; the rest of
    ``unmapped`` is fragments with no hit."""
    q = quantified
    t = q["res"].timings
    assert t["complex_fragments"] == q["complex"] > 0
    assert t["empty_intersection_fragments"] == q["dropped"] > 0
    assert q["res"].unmapped >= q["complex"] + q["dropped"]


def test_multi_gene_classes_exact(quantified):
    q = quantified
    genes = torch.from_numpy(q["genes"])
    off = q["ec_off"]
    spans = [genes[q["ec_tids"][off[e]:off[e + 1]].to(torch.int64)]
             .unique().numel() for e in range(off.numel() - 1)]
    want = sum(s > 1 for s in spans)
    assert q["res"].timings["multi_gene_classes"] == want > 0
