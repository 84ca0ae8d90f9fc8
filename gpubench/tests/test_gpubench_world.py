"""The worlds a configuration names by its generator: the isoform world
keyed and made as before the generators could be chosen, unknown or
path-like names refused, and ``worlds/gencode_families`` (gene families
and processed pseudogenes) repeatable, in its configured shares and
substitution rates, and sharing sequence between genes where the isoform
world shares none: classes whose members span genes, fragments over the
class cap."""

import hashlib
import json

import numpy as np
import pytest
import torch

from gpubench import manifest, simulate, world
from gpubench.reference import kmers
from gpubench.tests import tiny

FAM = manifest.load_module("worlds", "world generator", "gencode_families",
                           world.HERE)
K = 25


def params(generator="gencode_families", num_genes=60, **kw):
    p = dict(manifest.load_config("gencode_pe100")["world"],
             num_genes=num_genes, **kw)
    if generator == "gencode_families":
        p.update(tiny.FAMILIES)
    p["generator"] = generator
    return p


def old_key(wp):
    """The world's key as it was formed before generators could be
    chosen: the parameters and ``simulate.py``."""
    h = hashlib.sha1()
    for part in (json.dumps(wp, sort_keys=True).encode(),
                 (world.HERE / "simulate.py").read_bytes()):
        h.update(part)
        h.update(b"\0")
    return f"{wp['generator']}-{h.hexdigest()[:16]}"


def test_existing_worlds_keep_their_key():
    for name in ("gencode_pe100", "gencode_se75"):
        wp = manifest.load_config(name)["world"]
        assert old_key(wp) == "isoform_transcriptome-cb6ac44205683042"


def test_isoform_world_as_before(tmp_path):
    wp = params("isoform_transcriptome", num_genes=12)
    wdir, made = world.ensure_world(wp, tmp_path, lambda m: None)
    assert wdir == tmp_path / "worlds" / old_key(wp) and made > 0
    rng = np.random.default_rng(wp["seed"])
    names, seqs, genes = simulate.isoform_transcriptome(
        rng, wp["num_genes"], wp["mean_isoforms"], wp["mean_exons"],
        wp["mean_exon_len"])
    ex = wp["expression"]
    expr = simulate.power_law_expression(rng, len(seqs), ex["k"], ex["x1"],
                                         ex["full_transcripts"])
    with np.load(wdir / "world.npz") as z:
        assert np.array_equal(z["concat"],
                              simulate.seq_to_codes("".join(seqs)))
        assert z["lengths"].tolist() == [len(s) for s in seqs]
        assert np.array_equal(z["expression"], expr)
    fasta = (wdir / "transcripts.fa").read_text().split("\n")
    assert fasta[0::2][:-1] == [">" + n for n in names]
    assert world.ensure_world(wp, tmp_path, lambda m: None) == (wdir, 0.0)


@pytest.mark.parametrize("name", ["no_such_world", "../run", "worlds/x",
                                  "", "gencode_families/.."])
def test_unknown_generator_raises(tmp_path, name):
    with pytest.raises(ValueError, match=repr(name).replace(".", r"\.")):
        world.ensure_world(params(num_genes=12, generator=name), tmp_path,
                           lambda m: None)


def test_families_keyed_by_its_file(tmp_path):
    wp = params(num_genes=12)
    wdir, _ = world.ensure_world(wp, tmp_path, lambda m: None)
    assert wdir.name.startswith("gencode_families-")
    assert wdir.name != old_key(wp)


def test_families_repeat_from_a_seed():
    make, _ = world.generator("gencode_families")
    a = make(np.random.default_rng(3), params())
    assert a == make(np.random.default_rng(3), params())
    assert a[1] != make(np.random.default_rng(4), params())[1]


def test_families_shares_and_rates():
    p = params(num_genes=400)
    genes = FAM.draw(np.random.default_rng(5), p)
    kinds = [g.kind for g in genes]
    pseudo = round(0.23 * 400)
    assert len(genes) == 400 and kinds.count("pseudogene") == pseudo
    assert kinds.count("paralog") == round(0.15 * (400 - pseudo))
    assert kinds == sorted(kinds, key=["base", "paralog",
                                       "pseudogene"].index)
    fam = np.bincount([g.parent for g in genes if g.kind == "paralog"])
    assert fam.max() <= p["max_family"]
    subs = {"paralog": [0, 0], "pseudogene": [0, 0]}
    for g in genes:
        if g.kind == "paralog":
            pairs = zip(g.exons, genes[g.parent].exons)
        elif g.kind == "pseudogene":
            iso, cut = g.source
            mrna = genes[g.parent].isoform_codes(iso)
            assert cut <= p["pseudogene_truncation"] * mrna.size
            assert len(g.exons) == 1 and g.isoforms == [(0, (0,))]
            pairs = [(g.exons[0], mrna[cut:])]
        else:
            continue
        for a, b in pairs:
            assert a.shape == b.shape
            subs[g.kind][0] += int((a != b).sum())
            subs[g.kind][1] += a.size
    for kind in subs:
        lo, hi = p[f"{kind}_divergence"]
        assert lo <= subs[kind][0] / subs[kind][1] <= hi, (kind, subs[kind])
    names, seqs, gids = FAM.make(np.random.default_rng(5), p)
    assert len(set(gids)) == 400 and len(names) == len(set(names))
    assert len(seqs) == sum(len(g.isoforms) for g in genes)


def classes_a_fragment(tab, l1, l2):
    """The distinct classes of each fragment's windows found in ``tab``."""
    rows = []
    for c in (l1, l2):
        keys, valid = kmers.windows(torch.from_numpy(c), K)
        r = kmers.lookup(tab, keys, valid)
        rows.append(torch.where(r >= 0, tab["cls"][r.clamp(min=0)], -1))
    s = torch.sort(torch.cat(rows, 1).to(torch.int64), 1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return (new & (s >= 0)).sum(1)


@pytest.mark.parametrize("generator", ["isoform_transcriptome",
                                       "gencode_families"])
def test_sequence_shared_between_genes(generator):
    """Classes span genes and fragments pass a cap of 7 classes in the
    families world (the tiny families cell's cap); neither in the isoform
    world of as many genes."""
    make, _ = world.generator(generator)
    names, seqs, genes = make(np.random.default_rng(1), params(generator))
    gene = torch.tensor([int(g[4:]) for g in genes])
    lens = np.array([len(s) for s in seqs])
    concat = simulate.seq_to_codes("".join(seqs))
    tab = kmers.build_table(torch.from_numpy(concat), torch.from_numpy(lens),
                            K)
    off, tids = tab["cls_off"], tab["cls_tids"].to(torch.int64)
    spans = torch.tensor([gene[tids[off[i]:off[i + 1]]].unique().numel()
                          for i in range(off.numel() - 1)])
    l1, l2 = simulate.draw_sample(7, concat, lens, 1, 4000, 100, True, 200.0,
                                  20.0, 0.005)
    over = int((classes_a_fragment(tab, l1[0], l2[0]) > 7).sum())
    if generator == "gencode_families":
        assert (spans > 1).sum() > 50 and over > 10
    else:
        assert spans.max() == 1 and over == 0
