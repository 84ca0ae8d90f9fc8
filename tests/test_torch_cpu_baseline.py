"""The port's compiled single-core CPU baseline (``native/cpu_baseline``)
against the JAX package's copy, the oracle and the port's plain dense
``Mapper``; the repaired faults of the copy: the library built into
``build/seekmer_tpu_torch/`` and a failed build raising, ``max_ecs`` above
64 refused. CPU only, tiny worlds.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seekmer_tpu import encoding as jenc
from seekmer_tpu.config import IndexConfig, MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.native.cpu_baseline import CpuBaselineMapper as JBaseline
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
from seekmer_tpu_torch import encoding as tenc
from seekmer_tpu_torch import native
from seekmer_tpu_torch.config import MapConfig as TMapConfig
from seekmer_tpu_torch.io.fastq import ReadBatch
from seekmer_tpu_torch.map.driver import Mapper
from seekmer_tpu_torch.native import cpu_baseline
from seekmer_tpu_torch.native.cpu_baseline import CpuBaselineMapper
from tests.oracle import oracle
from tests.test_torch_self_contained import port_index

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
L = 100  # read length; shorter reads are padded with 4
N_READS = 384


@functools.lru_cache(maxsize=None)
def world(seed: int, k: int = 25, errors: bool = True):
    """A JAX index of 30 transcripts and N_READS reads drawn from it: with
    errors, 2% substitutions, ragged lengths (20-100) and an N in one read
    of ten; without, full-length reads as drawn. Returns (index, reads as
    strings, codes uint8[N_READS, L] padded with 4, lengths)."""
    rng = np.random.default_rng(seed)
    names, seqs = random_transcriptome(rng, num_transcripts=30, min_len=150,
                                       max_len=600, shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs, cfg=IndexConfig(k=k))
    sim = simulate_reads(rng, seqs, num_reads=N_READS, read_len=L,
                         error_rate=0.02 if errors else 0.0)
    reads = []
    for r in sim.reads1:
        if errors:
            r = r[:int(rng.integers(20, len(r) + 1))]
            if rng.random() < 0.1:
                j = int(rng.integers(0, len(r)))
                r = r[:j] + "N" + r[j + 1:]
        reads.append(r)
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = jenc.seq_to_codes(r)
    lengths = np.array([len(r) for r in reads], np.int32)
    return index, reads, codes, lengths


def tables(m):
    return m.sig_keys, m.sig_counts, m._sig_used


def assert_same_tables(got, want):
    for a, b in zip(tables(got), tables(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_skip", [False, True], ids=["dense", "skip"])
@pytest.mark.parametrize("k", [25, 17])
@pytest.mark.parametrize("seed", [1, 2])
def test_matches_jax_copy(seed, k, use_skip):
    """The same index arrays and codes give the same signature tables,
    element for element, and the same counts."""
    index, _, codes, _ = world(seed, k)
    j = JBaseline(index, sig_bits=12)
    with CpuBaselineMapper(port_index(index), sig_bits=12) as t:
        got = t.map(codes, use_skip=use_skip)
        want = j.map(codes, use_skip=use_skip)
        assert got == want and 0 < got < N_READS
        assert_same_tables(t, j)
        assert (t.distinct_signatures, t.total_mapped) == (
            j.distinct_signatures, j.total_mapped)
        assert t.total_mapped == got
    j.close()


@pytest.mark.parametrize("use_skip", [False, True], ids=["dense", "skip"])
def test_two_calls_equal_one(use_skip):
    """The table, its occupancy included, carries across map() calls."""
    index, _, codes, _ = world(1)
    with CpuBaselineMapper(port_index(index), sig_bits=12) as one, \
            CpuBaselineMapper(port_index(index), sig_bits=12) as two:
        n = one.map(codes, use_skip=use_skip)
        h = N_READS // 3
        assert two.map(codes[:h], use_skip=use_skip) + two.map(
            codes[h:], use_skip=use_skip) == n
        assert_same_tables(two, one)


def test_overflow_raises_at_the_same_call():
    """A 16-slot table holds 8 signatures: both copies raise at the same
    call, with the same table."""
    index, _, codes, _ = world(2)
    j = JBaseline(index, sig_bits=4)
    t = CpuBaselineMapper(port_index(index), sig_bits=4)

    def first_failure(m):
        for call, start in enumerate(range(0, N_READS, 4)):
            try:
                m.map(codes[start:start + 4])
            except RuntimeError as e:
                assert "overflow" in str(e)
                return call
        return None

    call = first_failure(t)
    assert call is not None and call == first_failure(j)
    assert_same_tables(t, j)
    assert t.distinct_signatures == 8
    t.close()
    j.close()


# at 2 ECs a read some reads are complex (unmapped), at 16 none here
MAX_ECS = pytest.mark.parametrize("max_ecs", [16, 2])


@MAX_ECS
@pytest.mark.parametrize("seed", [1, 2])
def test_matches_oracle(seed, max_ecs):
    """Mapped reads and distinct signatures equal the oracle's."""
    index, reads, codes, _ = world(seed)
    sigs, unmapped = oracle.map_reads(reads, index,
                                      MapConfig(max_ecs_per_read=max_ecs))
    if max_ecs == 2:
        assert unmapped > oracle.map_reads(reads, index, MapConfig())[1]
    with CpuBaselineMapper(port_index(index), sig_bits=12) as t:
        assert t.map(codes, max_ecs) == N_READS - unmapped
        assert t.distinct_signatures == len(sigs)


@MAX_ECS
@pytest.mark.parametrize("seed", [1, 2])
def test_matches_plain_dense_mapper(seed, max_ecs):
    """The raw MapResult.mapped (before the resolve drops) and the distinct
    signature rows of the port's plain dense Mapper on the CPU."""
    index, _, codes, lengths = world(seed)
    tindex = port_index(index)
    B = N_READS // 3
    cfg = TMapConfig(batch_size=B, sig_table_bits=12,
                     max_ecs_per_read=max_ecs)
    w = np.ones(B, np.int32)
    res = Mapper(tindex, cfg, device="cpu").run([
        ReadBatch(codes[i:i + B], lengths[i:i + B], w)
        for i in range(0, N_READS, B)])
    assert res.overflow == 0 and res.total_reads == N_READS
    with CpuBaselineMapper(tindex, sig_bits=12) as t:
        assert t.map(codes, cfg.max_ecs_per_read) == res.mapped
        assert t.distinct_signatures == res.sigs.shape[0]


def test_skip_equals_dense_on_error_free_reads():
    """Without errors no skipped window can collide: the skip arm's tables
    equal the dense arm's."""
    index, _, codes, _ = world(3, errors=False)
    with CpuBaselineMapper(port_index(index), sig_bits=12) as dense, \
            CpuBaselineMapper(port_index(index), sig_bits=12) as skip:
        assert dense.map(codes) == skip.map(codes, use_skip=True) > 0
        assert_same_tables(skip, dense)


def test_max_ecs_above_64_is_refused():
    """64 maps as the JAX copy does; 65 raises in the wrapper, and the C
    side refuses it too (-2, the table untouched), where the JAX copy
    clamped it to 64."""
    index, _, codes, _ = world(1)
    j = JBaseline(index, sig_bits=12)
    with CpuBaselineMapper(port_index(index), sig_bits=12) as t:
        assert t.map(codes, max_ecs=64) == j.map(codes, max_ecs=64)
        assert_same_tables(t, j)
        with pytest.raises(ValueError, match="max_ecs 65"):
            t.map(codes, max_ecs=65)
        keys = t.sig_keys.copy()
        got = cpu_baseline.get_lib().seekmer_cpu_map(
            t._h, cpu_baseline._ptr(codes, cpu_baseline.ctypes.c_uint8),
            N_READS, L, 65,
            cpu_baseline._ptr(t.sig_keys, cpu_baseline.ctypes.c_uint64),
            cpu_baseline._ptr(t.sig_counts, cpu_baseline.ctypes.c_int64),
            t.sig_size,
            cpu_baseline._ptr(t._sig_used, cpu_baseline.ctypes.c_int64), 0)
        assert got == -2
        np.testing.assert_array_equal(t.sig_keys, keys)
    j.close()


def test_library_is_built_under_build_dir(tmp_path, monkeypatch):
    """The library lands in build/seekmer_tpu_torch/ with the source's hash
    in its name; a fresh build writes nothing beside the source."""
    src_dir = REPO / "seekmer_tpu_torch" / "native"
    before = sorted(p.name for p in src_dir.iterdir())
    path = cpu_baseline.build()
    assert path.parent == REPO / "build" / "seekmer_tpu_torch"
    assert re.fullmatch(r"libseekmer_cpu_[0-9a-f]{12}\.so", path.name)
    assert Path(cpu_baseline.get_lib()._name) == path
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    fresh = cpu_baseline.build()
    assert fresh.parent == tmp_path / "b" and fresh.name == path.name
    assert sorted(p.name for p in src_dir.iterdir()) == before


@pytest.mark.parametrize("compiler", ["none", "failing"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """No compiler on PATH, or one that fails: RuntimeError, no library."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if compiler == "failing":
        cc = bin_dir / "cc"
        cc.write_text("#!/bin/sh\nexit 1\n")
        cc.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    match = "no C compiler" if compiler == "none" else "failed"
    with pytest.raises(RuntimeError, match=match):
        cpu_baseline.build()
    assert not list((tmp_path / "b").glob("*.so"))


@pytest.mark.parametrize("k", [5, 17, 25, 29])
def test_join_key_matches_jax(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), 5000, dtype=np.uint64)
    hi, lo = tenc.split_key(keys, k)
    got = tenc.join_key(hi, lo, k)
    np.testing.assert_array_equal(got, jenc.join_key(hi, lo, k))
    np.testing.assert_array_equal(got, keys)
