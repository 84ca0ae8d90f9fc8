"""The port owns its host code: no module of ``seekmer_tpu_torch`` and not
``chip_smoke.py`` imports JAX or ``seekmer_tpu``; the port runs its CLI with
both blocked; and its copies of the JAX package's host modules (config,
encoding, hashes, index build and store, FASTQ ingest, writer, simulator)
agree with the originals, which stay the reference here.

Also the two faults repaired in the port's copy of ``native/packer.c``: the
radix sort now orders keys of every width ``IndexConfig`` allows (k <= 29,
2k <= 58 bits).
"""

import ast
import dataclasses
import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import seekmer_tpu.config as jconfig
from seekmer_tpu import cli as jcli
from seekmer_tpu import encoding as jenc
from seekmer_tpu.index import build as jbuild
from seekmer_tpu.index.store import KMerIndex as JKMerIndex
from seekmer_tpu.io import fastq as jfastq
from seekmer_tpu.io import writer as jwriter
from seekmer_tpu.ops import hash as jhash
from seekmer_tpu.utils import simulate as jsim
from seekmer_tpu_torch import cli as tcli
from seekmer_tpu_torch import config as tconfig
from seekmer_tpu_torch import encoding as tenc
from seekmer_tpu_torch.index import build as tbuild
from seekmer_tpu_torch.index.store import KMerIndex
from seekmer_tpu_torch.io import fastq as tfastq
from seekmer_tpu_torch.io import writer as twriter
from seekmer_tpu_torch.native import packer as tpacker
from seekmer_tpu_torch.ops import hash as thash
from seekmer_tpu_torch.utils import simulate as tsim

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
INDEX_ARRAYS = ("table", "stash", "ec_offsets", "ec_transcripts", "names",
                "lengths", "genes", "fld_tid", "fld_pos")
INDEX_SCALARS = ("k", "main_slots", "stash_slots", "bucket")


def port_index(index) -> KMerIndex:
    """A JAX ``KMerIndex`` as the port's own type, array for array."""
    return KMerIndex(**{f.name: getattr(index, f.name)
                        for f in dataclasses.fields(KMerIndex)})


def port_config(cfg):
    """A JAX configuration (IndexConfig, MapConfig, EMConfig or
    PipelineConfig) as the port's class of the same name and values."""
    if isinstance(cfg, jconfig.PipelineConfig):
        return tconfig.PipelineConfig(index=port_config(cfg.index),
                                      map=port_config(cfg.map),
                                      em=port_config(cfg.em),
                                      shard=port_config(cfg.shard))
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def assert_same_index(a, b):
    for name in INDEX_SCALARS:
        assert getattr(a, name) == getattr(b, name), name
    for name in INDEX_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


# ---- no import of JAX or of the JAX package --------------------------------


def _port_sources():
    """The port (``parallel/`` included), ``chip_smoke.py`` and the rank
    functions the multi-process tests spawn."""
    files = sorted((REPO / "seekmer_tpu_torch").rglob("*.py"))
    return files + sorted((REPO / "tools").glob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_workers.py"]


def _banned(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "seekmer_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of JAX fails
sys.modules["seekmer_tpu"] = None  # and any import of the JAX package
import numpy as np
import seekmer_tpu_torch
for m in pkgutil.walk_packages(seekmer_tpu_torch.__path__,
                               "seekmer_tpu_torch."):
    importlib.import_module(m.name)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.utils.simulate import (
    random_transcriptome, simulate_reads, write_fasta, write_fastq)
work = sys.argv[1]
rng = np.random.default_rng(5)
names, seqs = random_transcriptome(rng, num_transcripts=24, min_len=200,
                                   max_len=500, shared_prefix_frac=0.5)
write_fasta(work + "/ref.fa", names, seqs)
pairs = simulate_reads(rng, seqs, num_reads=400, read_len=80, paired=True,
                       mean_frag=190.0)
write_fastq(work + "/r1.fq", pairs.reads1)
write_fastq(work + "/r2.fq", pairs.reads2)
assert cli.main(["index", work + "/ref.fa", work + "/index.npz"]) == 0
assert cli.main(["infer", work + "/index.npz", work + "/out", work + "/r1.fq",
                 "--mates", work + "/r2.fq", "--bootstrap", "2",
                 "--device", "cpu", "--batch-size", "256",
                 "--sig-table-bits", "10"]) == 0
assert cli.main(["infer", work + "/index.npz", work + "/out_s4",
                 work + "/r1.fq", "--mates", work + "/r2.fq",
                 "--probe-stride", "4", "--device", "cpu",
                 "--batch-size", "256", "--sig-table-bits", "10"]) == 0
assert cli.main(["fuse", work + "/index.npz", work + "/fuse_out",
                 work + "/r1.fq", "--mates", work + "/r2.fq", "--device",
                 "cpu", "--batch-size", "256", "--sig-table-bits", "10",
                 "--min-count", "1"]) == 0
assert sys.modules["jax"] is None and sys.modules["seekmer_tpu"] is None
print("BLOCKED_OK")
"""


def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """Every module of the port imports, and ``index``, a paired ``infer
    --device cpu --bootstrap 2``, a strided ``infer --probe-stride 4`` and
    ``fuse`` succeed, in a process where JAX and ``seekmer_tpu`` cannot be
    imported; their abundance and fusion tables equal those of the same
    runs with both importable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    outs = []
    for blocked in (True, False):
        work = tmp_path / ("blocked" if blocked else "open")
        work.mkdir()
        code = _BLOCKED if blocked else _BLOCKED.replace(
            'sys.modules["jax"] = None', 'import seekmer_tpu').replace(
            'sys.modules["seekmer_tpu"] = None', '').replace(
            'assert sys.modules["jax"] is None and '
            'sys.modules["seekmer_tpu"] is None', '')
        r = subprocess.run([sys.executable, "-c", code, str(work)],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "BLOCKED_OK" in r.stdout
        outs.append([(work / name).read_bytes() for name in (
            "out/abundance.tsv", "out_s4/abundance.tsv",
            "fuse_out/fusions.tsv")])
    assert outs[0] == outs[1]


# ---- the copies against the originals ---------------------------------------


@pytest.mark.parametrize("name", ["IndexConfig", "MapConfig", "EMConfig",
                                  "ShardConfig", "PipelineConfig"])
def test_config_fields_and_defaults_match(name):
    """Same fields, defaults and validation, ``ShardConfig`` and
    ``PipelineConfig.shard`` included."""
    def default(f):
        d = f.default
        return dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d

    want = {f.name: default(f) for f in dataclasses.fields(
        getattr(jconfig, name))}
    got = {f.name: default(f) for f in dataclasses.fields(
        getattr(tconfig, name))}
    assert got == want
    assert port_config(getattr(jconfig, name)()) == getattr(tconfig, name)()
    if name == "IndexConfig":
        with pytest.raises(ValueError, match="k must be"):
            tconfig.IndexConfig(k=30)


def test_hashes_and_encoding_match():
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 2**31, 5000, dtype=np.int64).astype(np.uint32)
    lo = rng.integers(0, 2**31, 5000, dtype=np.int64).astype(np.uint32)
    np.testing.assert_array_equal(thash.hash_kmer_np(hi, lo),
                                  jhash.hash_kmer(hi, lo))
    np.testing.assert_array_equal(thash.hash_kmer_stash_np(hi, lo),
                                  jhash.hash_kmer_stash(hi, lo))
    seq = "".join(rng.choice(list("ACGTNacgt"), 3000))
    np.testing.assert_array_equal(tenc.seq_to_codes(seq),
                                  jenc.seq_to_codes(seq))
    codes = jenc.seq_to_codes(seq)
    for k in (5, 25, 29):
        for a, b in zip(tenc.canonical_kmers(codes, k),
                        jenc.canonical_kmers(codes, k)):
            np.testing.assert_array_equal(a, b)
        keys, _ = jenc.canonical_kmers(codes, k)
        for a, b in zip(tenc.split_key(keys, k), jenc.split_key(keys, k)):
            np.testing.assert_array_equal(a, b)
    batch = rng.integers(0, 5, (7, 37)).astype(np.uint8)
    for a, b in zip(tenc.pack_codes_2bit(batch), jenc.pack_codes_2bit(batch)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny isoform world on disk: FASTA, GTF, paired FASTQ (one mate
    gzipped) with ragged lengths and N bases."""
    d = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(8)
    names, seqs, genes = tsim.isoform_transcriptome(rng, num_genes=12)
    tsim.write_fasta(str(d / "ref.fa"), names, seqs)
    with open(d / "ref.gtf", "w") as fh:
        for n, g in zip(names, genes):
            fh.write(f"chr1\tsim\ttranscript\t1\t2\t.\t+\t.\t"
                     f'gene_id "{g}"; transcript_id "{n}";\n')
    sim = tsim.simulate_reads(rng, seqs, num_reads=700, read_len=90,
                              paired=True, mean_frag=200.0, error_rate=0.01)

    def ragged(reads):
        out = []
        for r in reads:
            r = r[:int(rng.integers(25, len(r) + 1))]
            if rng.random() < 0.1:
                j = int(rng.integers(0, len(r)))
                r = r[:j] + "N" + r[j + 1:]
            out.append(r)
        return out

    tsim.write_fastq(str(d / "r1.fq"), ragged(sim.reads1))
    tsim.write_fastq(str(d / "r2.fq.gz"), ragged(sim.reads2))
    return d, names, seqs, genes


@pytest.mark.parametrize("native_sort", [False, True],
                         ids=["numpy_sort", "radix_sort"])
def test_build_index_matches(world, native_sort, monkeypatch):
    """Equal index arrays from the same FASTA and GTF, through numpy's sort
    and through both packages' C radix sorts (k = 25)."""
    d = world[0]
    if native_sort:
        monkeypatch.setattr(jbuild, "_NATIVE_SORT_MIN", 0)
        monkeypatch.setattr(tbuild, "_NATIVE_SORT_MIN", 0)
    for cfg in (jconfig.IndexConfig(), jconfig.IndexConfig(k=21,
                                                           bucket_size=4)):
        want = jbuild.build_index(str(d / "ref.fa"), str(d / "ref.gtf"), cfg)
        got = tbuild.build_index(str(d / "ref.fa"), str(d / "ref.gtf"),
                                 port_config(cfg))
        assert_same_index(got, want)
        assert got.genes is not None and got.fld_tid is not None


def test_index_files_cross_load(world, tmp_path):
    """An index written by either package's CLI loads in the other with
    equal arrays."""
    d = world[0]
    j_out, t_out = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    argv = ["index", str(d / "ref.fa"), "--gtf", str(d / "ref.gtf")]
    assert jcli.main(argv[:2] + [j_out] + argv[2:]) == 0
    assert tcli.main(argv[:2] + [t_out] + argv[2:]) == 0
    assert_same_index(KMerIndex.load(j_out), JKMerIndex.load(j_out))
    assert_same_index(JKMerIndex.load(t_out), KMerIndex.load(t_out))
    assert_same_index(KMerIndex.load(j_out), KMerIndex.load(t_out))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("codes", "lengths", "weights", "codes2", "lengths2"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        g2, w2 = tfastq.pack_batch_2bit(g), jfastq.pack_batch_2bit(w)
        for f in ("codes", "bad", "codes2", "bad2", "pad_len"):
            np.testing.assert_array_equal(getattr(g2, f), getattr(w2, f))


@pytest.mark.parametrize("io_workers", [1, 2])
def test_native_batches_match(world, io_workers):
    """batch_reads_native and batch_read_pairs_native give the same batches
    (serial, and with two decode threads over two files)."""
    d = world[0]
    cfg = jconfig.MapConfig(batch_size=64, io_workers=io_workers,
                            paired_end=True)
    files1 = [str(d / "r1.fq")] * io_workers
    files2 = [str(d / "r2.fq.gz")] * io_workers
    want = list(jfastq.batch_reads_native(files1, cfg))
    got = list(tfastq.batch_reads_native(files1, port_config(cfg)))
    if io_workers > 1:  # files interleave in arrival order
        key = lambda b: (b.codes.shape[1], b.codes.tobytes())  # noqa: E731
        want, got = sorted(want, key=key), sorted(got, key=key)
    _assert_same_batches(got, want)
    want = list(jfastq.batch_read_pairs_native(files1, files2, cfg))
    got = list(tfastq.batch_read_pairs_native(files1, files2,
                                              port_config(cfg)))
    if io_workers > 1:
        want, got = sorted(want, key=key), sorted(got, key=key)
    _assert_same_batches(got, want)


def test_writer_output_is_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    T = 40
    names = np.array([f"t{i}" for i in range(T)])
    genes = np.array([f"g{i // 3}" for i in range(T)])
    lengths = rng.integers(100, 3000, T)
    eff = rng.uniform(1, 3000, T)
    counts = rng.exponential(100, T)
    tpm = counts / counts.sum() * 1e6
    boot = rng.exponential(100, (3, T))
    for mod, tag in ((jwriter, "j"), (twriter, "t")):
        mod.write_abundance(str(tmp_path / f"{tag}.tsv"), names, lengths,
                            eff, counts, tpm)
        mod.write_gene_abundance(str(tmp_path / f"{tag}.genes.tsv"), genes,
                                 counts, tpm)
        mod.write_run_info(str(tmp_path / f"{tag}.json"),
                           {"a": 1, "b": [1.5, "x"]})
        mod.write_bootstrap(str(tmp_path / f"{tag}.npz"), names, boot)
    for suffix in (".tsv", ".genes.tsv", ".json"):
        assert ((tmp_path / f"t{suffix}").read_bytes()
                == (tmp_path / f"j{suffix}").read_bytes())
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    for key in ("names", "est_counts"):
        np.testing.assert_array_equal(a[key], b[key])
    t = twriter.read_abundance(str(tmp_path / "j.tsv"))
    np.testing.assert_array_equal(t["target_id"], names)


def test_simulator_gives_equal_worlds():
    def draw(mod):
        rng = np.random.default_rng(11)
        names, seqs = mod.random_transcriptome(rng, num_transcripts=20,
                                               shared_prefix_frac=0.4)
        inames, iseqs, igenes = mod.isoform_transcriptome(rng, num_genes=5)
        se = mod.simulate_reads(rng, seqs, num_reads=50, error_rate=0.02)
        pe = mod.simulate_reads(rng, seqs, num_reads=50, paired=True)
        packed = mod.simulate_packed_batches(rng, seqs, 2, 16)
        pairs = mod.simulate_packed_pairs(rng, iseqs, 2, 16, read_len=60)
        return (names, seqs, inames, iseqs, igenes, se.reads1,
                se.true_transcript, pe.reads1, pe.reads2, *packed, *pairs)

    for a, b in zip(draw(tsim), draw(jsim)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fastq_writer_and_gzip_roundtrip(tmp_path):
    """The copied simulator's FASTQ writer and the C reader agree on a
    gzipped file."""
    reads = ["ACGTN" * 5, "ACG", "T" * 40]
    tsim.write_fastq(str(tmp_path / "x.fq.gz"), reads)
    with gzip.open(tmp_path / "x.fq.gz", "rt") as fh:
        assert fh.read().count("@read") == 3
    (codes, lengths), = tpacker.stream_packed(str(tmp_path / "x.fq.gz"), 48)
    np.testing.assert_array_equal(lengths, [25, 3, 40])
    np.testing.assert_array_equal(codes[0, :5], [0, 1, 2, 3, 4])


# ---- the repaired radix sort ------------------------------------------------


@pytest.mark.parametrize("k", [25, 27, 29])
def test_radix_sort_matches_argsort_at_every_key_width(k):
    """2^20 random canonical-width keys in stream order: the port's C radix
    sort equals numpy's stable argsort, gathers and rank scatter. The
    reference's fixed four 13-bit passes cover 52 bits, which k = 27 and
    29 (54 and 58 bits) exceed."""
    rng = np.random.default_rng(k)
    n = 1 << 20
    keys = rng.integers(0, 1 << (2 * k), n, dtype=np.uint64)
    keys[: n // 8] = keys[n // 2: n // 2 + n // 8]  # repeated keys
    tids = np.sort(rng.integers(0, 5000, n)).astype(np.int32)
    got_k, got_t, got_r = tpacker.sort_pairs_native(keys, tids, nthreads=2)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[order])
    np.testing.assert_array_equal(got_t, tids[order])
    first = np.ones(n, bool)
    first[1:] = keys[order][1:] != keys[order][:-1]
    rank = np.empty(n, np.int64)
    rank[order] = np.cumsum(first) - 1
    np.testing.assert_array_equal(got_r, rank)
