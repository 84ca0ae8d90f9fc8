"""Fusion mode in the port against the JAX package: the ``Mapper`` with
``fusion_pairs`` (dense and strided), ``call_fusions`` and
``detect_fusions_files``, the ``fuse`` CLI's files and flags, and K3's
plain ``segments=2`` against two JAX signature calls. Every stage is
integer work: every comparison is exact."""

import argparse
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu.cli import build_parser as j_build_parser
from seekmer_tpu.cli import main as j_main
from seekmer_tpu.config import MapConfig
from seekmer_tpu.fusion import call_fusions as j_call_fusions
from seekmer_tpu.fusion import detect_fusions_files as j_detect
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.map.signature import read_signatures as j_read_signatures
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch import cli, fusion
from seekmer_tpu_torch.map.driver import Mapper
from seekmer_tpu_torch.map.signature import read_signatures
from tests.synthetic_signatures import adversarial_rows
from tests.test_torch_fast import _batches, _same_result
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)
C = 8


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")
def world():
    """tests/test_fusion.py's world (20 genes of one transcript, GENE0 with
    a second isoform) and pairs of every kind: concordant, fused across two
    genes, same-gene discordant, junction-spanning split reads (with a
    consistent partner, and with one in a third gene), a fusion with one
    supporting pair, simulated pairs with errors, and junk."""
    rng = np.random.default_rng(1312)
    names, seqs = random_transcriptome(
        rng, num_transcripts=20, min_len=300, max_len=600,
        shared_prefix_frac=0.0)
    seqs = list(seqs) + [seqs[0][:200] + seqs[1][200:400]]
    names = list(names) + ["txp_iso"]
    genes = [f"GENE{i}" for i in range(20)] + ["GENE0"]
    index = build_index_from_seqs(names, seqs, genes=genes)
    pairs = []
    for t in (2, 3, 4):
        s = seqs[t]
        pairs += [(s[i:i + 100], _revcomp(s[-(100 + i):len(s) - i]))
                  for i in range(5)]
    a, b = seqs[5], seqs[7]
    pairs += [(a[i:i + 100], _revcomp(b[i:i + 100])) for i in range(6)]
    pairs += [(seqs[20][150:250], _revcomp(seqs[0][-100:]))] * 3
    fused = a[:250] + b[250:]
    pairs += [(fused[250 - 50 - i: 250 + 50 - i],
               _revcomp(fused[250 + 60 + i: 250 + 160 + i]))
              for i in range(4)]
    pairs += [(fused[200:300], _revcomp(seqs[9][100:200]))] * 3
    pairs += [(seqs[9][:100], _revcomp(seqs[11][:100]))]
    sim = simulate_reads(rng, seqs, num_reads=150, read_len=100,
                         paired=True, mean_frag=220.0, error_rate=0.01)
    pairs += list(zip(sim.reads1, sim.reads2))
    pairs += [("".join(rng.choice(list("ACGT"), size=100)),
               "".join(rng.choice(list("ACGT"), size=100)))
              for _ in range(10)]
    return index, [p[0] for p in pairs], [p[1] for p in pairs]


def _cfg(stride=1):
    return MapConfig(batch_size=64, sig_table_bits=12, paired_end=True,
                     fusion_pairs=True, max_ecs_per_read=C,
                     probe_stride=stride, collision_audit_every=2)


def _both(index, r1, r2, cfg):
    want = JMapper(index, cfg).run(_batches(r1, r2, cfg))
    mapper = Mapper(port_index(index), port_config(cfg), device="cpu")
    got = mapper.run(_batches(r1, r2, cfg))
    return got, want, mapper


def _same_report(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("stride", [1, 4], ids=["dense", "strided_s4"])
def test_mapper_fusion_matches_jax(world, stride):
    """The fusion MapResult equals the JAX Mapper's, with and without
    strided mode; the table is 2C wide with no per-EC vector, and a pair
    counts only when both mates map (mapped = mapped1 & mapped2)."""
    index, r1, r2 = world
    got, want, mapper = _both(index, r1, r2, _cfg(stride))
    _same_result(got, want)
    assert mapper.table.sig.shape[1] == 2 * C
    assert mapper.table.ec_count.shape == (1,)
    halves = got.sigs.reshape(-1, 2, C)[:, :, 0] != 0x7FFFFFFF
    assert halves.all()
    assert 0 < got.mapped < got.total_reads == len(r1)


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("stride", [1, 4], ids=["dense", "strided_s4"])
def test_call_fusions_matches_jax(world, stride, min_count):
    """call_fusions on the port's MapResult gives the JAX report on the
    JAX MapResult, field for field: candidates (genes, pair and split
    support, transcripts) and every tally."""
    index, r1, r2 = world
    got, want, _ = _both(index, r1, r2, _cfg(stride))
    rep = fusion.call_fusions(got, port_index(index), C, min_count=min_count)
    _same_report(rep, j_call_fusions(want, index, C, min_count=min_count))
    pairs = {(c.gene1, c.gene2): c for c in rep.candidates}
    assert pairs[("GENE5", "GENE7")].count >= 6
    assert pairs[("GENE5", "GENE7")].split_reads >= 4
    assert rep.concordant >= 15 and rep.same_gene_discordant >= 3
    assert (("GENE11", "GENE9") in pairs) == (min_count == 1)


def _write_pairs(tmp_path, r1, r2):
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    write_fastq(f1, r1)
    write_fastq(f2, r2)
    return f1, f2


def test_detect_fusions_files_matches_jax(world, tmp_path):
    """detect_fusions_files over FASTQ files, strided through MapConfig
    (the ``fuse`` CLI has no stride flag in either package), gives the JAX
    report."""
    index, r1, r2 = world
    f1, f2 = _write_pairs(tmp_path, r1, r2)
    cfg = MapConfig(batch_size=64, sig_table_bits=12, max_ecs_per_read=C,
                    probe_stride=4)
    want = j_detect(index, [f1], [f2], cfg=cfg, min_count=1)
    got = fusion.detect_fusions_files(port_index(index), [f1], [f2],
                                      cfg=port_config(cfg), min_count=1,
                                      device="cpu")
    _same_report(got, want)
    assert got.candidates


def test_cli_fuse_matches_jax(world, tmp_path):
    """``fuse`` of both CLIs on the same index and FASTQ files: byte-equal
    fusions.tsv and equal run_info.json."""
    index, r1, r2 = world
    f1, f2 = _write_pairs(tmp_path, r1, r2)
    idx = str(tmp_path / "idx.npz")
    index.save(idx)
    argv = [idx, "OUT", f1, "--mates", f2, "--batch-size", "64",
            "--sig-table-bits", "12", "--min-count", "1"]
    outs = {}
    for tag, main, extra in (("jax", j_main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / tag
        a = [str(out) if x == "OUT" else x for x in argv]
        assert main(["fuse", *a, *extra]) == 0
        outs[tag] = ((out / "fusions.tsv").read_bytes(),
                     json.loads((out / "run_info.json").read_text()))
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].decode().splitlines()
    assert lines[0].startswith("gene1\tgene2") and len(lines) > 2


def _fuse_parser(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices["fuse"]


def test_cli_parses_every_jax_fuse_flag():
    """Every option of the JAX CLI's ``fuse`` parses in the port's to the
    same dest and value, and the port adds only ``--device``."""
    jax_fuse, port = _fuse_parser(j_build_parser()), _fuse_parser(
        cli.build_parser())
    dests = set()
    for action in jax_fuse._actions:
        if not action.option_strings or action.dest == "help":
            continue
        dests.add(action.dest)
        opt = action.option_strings[-1]
        if action.nargs == 0:
            argv, want = [opt], True
        elif action.nargs in ("*", "+"):
            argv, want = [opt, "x.fq"], ["x.fq"]
        else:
            want = (action.type or str)("3")
            argv = [opt, "3"]
        base = ["idx.npz", "out", "r1.fq"]
        if action.dest != "mates":
            base += ["--mates", "r2.fq"]
        args = port.parse_args([*base, *argv])
        assert getattr(args, action.dest) == want, (opt, argv)
    extra = {a.dest for a in port._actions if a.option_strings
             and a.dest != "help"} - dests
    assert extra == {"device"}
    assert port.parse_args(["i", "o", "r1", "--mates", "r2"]).device == "cuda"


@pytest.mark.parametrize("P", [76, 101, 208])
def test_signature_segments_match_two_jax_calls(P):
    """K3's plain version at segments=2 equals JAX's fusion branch: one
    read_signatures call a half, side by side, mapped the AND; runs do not
    join across the halves (rows whose halves' runs meet at the boundary,
    and K3's adversarial rows as halves)."""
    rng = np.random.default_rng(P)
    B = 300
    ecs = rng.integers(0, 12, (B, 2 * P)).astype(np.int32)
    ecs[rng.random((B, 2 * P)) < 0.2] = -1
    ecs[:50] = np.repeat(rng.integers(0, 4, (50, 1)), 2 * P, axis=1)
    valid = rng.random((B, 2 * P)) < 0.9
    valid[:50] = True
    adv, adv_valid = adversarial_rows(P, C, seed=P)
    n = adv.shape[0] // 2 * 2
    ecs = np.concatenate([ecs, adv[:n].reshape(n // 2, 2 * P)])
    valid = np.concatenate([valid, adv_valid[:n].reshape(n // 2, 2 * P)])
    sig, mapped = read_signatures(torch.from_numpy(ecs),
                                  torch.from_numpy(valid), C, segments=2)
    halves = [j_read_signatures(jnp.asarray(ecs[:, g * P:(g + 1) * P]),
                                jnp.asarray(valid[:, g * P:(g + 1) * P]), C)
              for g in range(2)]
    np.testing.assert_array_equal(
        sig.numpy(), np.concatenate([np.asarray(h[0]) for h in halves], 1))
    np.testing.assert_array_equal(
        mapped.numpy(), np.asarray(halves[0][1]) & np.asarray(halves[1][1]))
    assert mapped.any() and not mapped.all()
    one = read_signatures(torch.from_numpy(ecs), torch.from_numpy(valid), C)
    assert one[0].shape == (ecs.shape[0], C)


def test_single_end_fusion_raises(world):
    """Fusion needs pairs: a single-end batch fails in both packages, and
    the port's error names the paired-end requirement."""
    index, r1, _ = world
    cfg = dataclasses.replace(_cfg(), paired_end=False)
    batches = _batches(r1[:64], None, cfg)
    with pytest.raises(Exception):
        JMapper(index, cfg).run(batches)
    with pytest.raises(ValueError, match="paired-end"):
        Mapper(port_index(index), port_config(cfg), device="cpu").run(batches)
