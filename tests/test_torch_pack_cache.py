"""The port's pack cache (``io/pack_cache``) on the CPU: a build and a hit
give the FASTQ run's results, a stale cache is rebuilt, a cached run
resumes from its checkpoint, the two cursor kinds refuse each other, the
bin files are byte-equal to the JAX writer's, a hit never decodes, and
fault 2 is repaired: a checkpoint from another build of the cache is
refused, and a cache the JAX package built is rebuilt."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.models.quantifier import Quantifier as JQuantifier
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch.io import fastq as tfastq
from seekmer_tpu_torch.io import pack_cache as tpc
from seekmer_tpu_torch.map.driver import Mapper
from seekmer_tpu_torch.map.signature import SIG_PAD
from seekmer_tpu_torch.models.quantifier import Quantifier
from seekmer_tpu_torch.utils.prefetch import device_put_batches
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(42)
    names, seqs = random_transcriptome(rng, num_transcripts=30)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=700, read_len=100,
                         error_rate=0.005, paired=True)
    d = tmp_path_factory.mktemp("pc")
    fq1, fq2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    write_fastq(fq1, sim.reads1)
    write_fastq(fq2, sim.reads2)
    return index, port_index(index), fq1, fq2


def _cfg(**map_kw):
    return port_config(PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12, **map_kw),
        em=EMConfig(rel_tol=1e-6, estimate_fld=False)))


def _q(world, cfg=None):
    return Quantifier(world[1], cfg or _cfg(), device="cpu")


def _key(res):
    return (res.total_reads, res.mapped, res.unmapped,
            res.est_counts.tobytes())


def _as_dict(r):
    return {tuple(row[row != int(SIG_PAD)].tolist()): int(n)
            for row, n in zip(r.sigs, r.sig_counts)}


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
def test_cache_build_then_hit_identical(world, tmp_path, paired):
    _, _, fq1, fq2 = world
    mates = [fq2] if paired else None
    cache = str(tmp_path / "cache.smpack")
    fresh = _q(world).quantify_files([fq1], mates)
    built = _q(world).quantify_files([fq1], mates, pack_cache=cache)
    assert os.path.exists(os.path.join(cache, "meta.json"))
    assert tpc.cache_valid(cache, _cfg().map, [fq1], mates)
    cached = _q(world).quantify_files([fq1], mates, pack_cache=cache)
    assert _key(built) == _key(fresh) == _key(cached)


def test_hit_never_decodes(world, tmp_path, monkeypatch):
    """A hit reads memmap slices: the C reader and the 2-bit pack are
    never called, and the upload copies read-only arrays without the
    warning ``torch.from_numpy`` gives for them."""
    _, _, fq1, fq2 = world
    cache = str(tmp_path / "nd.smpack")
    fresh = _q(world).quantify_files([fq1], [fq2], pack_cache=cache)

    def forbidden(*a, **k):
        raise AssertionError("a cache hit decoded or packed")

    from seekmer_tpu_torch.native import packer

    monkeypatch.setattr(packer, "stream_packed", forbidden)
    monkeypatch.setattr(packer.PackedFileStream, "__init__", forbidden)
    monkeypatch.setattr(tfastq, "pack_codes_2bit", forbidden)
    batches = list(tpc.PackCacheSource(cache, _cfg().map))
    assert all(isinstance(b.codes, np.memmap) for b in batches)
    assert not batches[0].codes.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        up = list(device_put_batches(iter(batches), "cpu"))
    assert up[0].codes.dtype == torch.uint8 and up[0].cursor is not None
    cached = _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    assert _key(cached) == _key(fresh)


def test_stale_cache_rebuilt(world, tmp_path):
    _, _, fq1, fq2 = world
    cache = str(tmp_path / "st.smpack")
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    meta_path = os.path.join(cache, "meta.json")
    meta = json.load(open(meta_path))
    meta["sources"][0][1] += 1  # a source file changed
    json.dump(meta, open(meta_path, "w"))
    assert not tpc.cache_valid(cache, _cfg().map, [fq1], [fq2])
    fresh = _q(world).quantify_files([fq1], [fq2])
    rebuilt = _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    assert tpc.cache_valid(cache, _cfg().map, [fq1], [fq2])
    assert json.load(open(meta_path))["build_id"] != meta["build_id"]
    assert _key(rebuilt) == _key(fresh)


def _interrupted_checkpoint(world, cache, ckpt, cfg):
    m = Mapper(world[1], cfg.map, device="cpu")
    for n, b in enumerate(tpc.PackCacheSource(cache, cfg.map), 1):
        m.feed(b)
        if n == 3:
            assert b.cursor["v"] == "pack1" and b.cursor["build"]
            m.save_checkpoint(ckpt, stream_state=b.cursor)
            return b.cursor
    raise AssertionError("cache holds fewer than 3 batches")


def test_cached_checkpoint_resume(world, tmp_path):
    """A cached run stopped after its third batch's save and resumed:
    exact."""
    _, _, fq1, fq2 = world
    cache, ckpt = str(tmp_path / "ck.smpack"), str(tmp_path / "ck.npz")
    cfg = _cfg()
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    full = Mapper(world[1], cfg.map, device="cpu").run(
        iter(tpc.PackCacheSource(cache, cfg.map)))
    _interrupted_checkpoint(world, cache, ckpt, cfg)
    m2 = Mapper(world[1], cfg.map, device="cpu")
    src2 = tpc.PackCacheSource(cache, cfg.map)
    src2.restore(m2.restore_checkpoint(ckpt))
    res = m2.run(iter(src2))
    assert (res.total_reads, res.mapped) == (full.total_reads, full.mapped)
    assert _as_dict(res) == _as_dict(full)
    # the quantifier resumes a cached run from the same file
    resumed = _q(world).quantify_files([fq1], [fq2], pack_cache=cache,
                                       checkpoint_path=ckpt)
    fresh = _q(world).quantify_files([fq1], [fq2])
    assert _key(resumed) == _key(fresh)


def test_fault2_checkpoint_from_another_build_refused(world, tmp_path):
    """Fault 2: a checkpoint taken on one build of the cache is refused
    once the cache has been rebuilt (its batches may come in another
    order), by the source and by the quantifier; a cursor without a build
    id (the JAX package's) is refused too."""
    _, _, fq1, fq2 = world
    cache, ckpt = str(tmp_path / "f2.smpack"), str(tmp_path / "f2.npz")
    cfg = _cfg()
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    cursor = _interrupted_checkpoint(world, cache, ckpt, cfg)
    tpc.PackCacheSource(cache, cfg.map).restore(cursor)  # same build: fine
    os.remove(os.path.join(cache, "meta.json"))  # force a rebuild
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    with pytest.raises(ValueError, match="rebuilt since the checkpoint"):
        tpc.PackCacheSource(cache, cfg.map).restore(cursor)
    with pytest.raises(ValueError, match="rebuilt since the checkpoint"):
        _q(world).quantify_files([fq1], [fq2], pack_cache=cache,
                                 checkpoint_path=ckpt)
    legacy = {k: v for k, v in cursor.items() if k != "build"}
    with pytest.raises(ValueError, match="rebuilt since the checkpoint"):
        tpc.PackCacheSource(cache, cfg.map).restore(legacy)


def test_jax_built_cache_is_rebuilt(world, tmp_path):
    """A cache the JAX package built carries no build id: stale here, and
    rebuilt by the port's run; its bin files are byte-equal to the port's
    rebuild of the same input."""
    index, _, fq1, fq2 = world
    cache = str(tmp_path / "jx.smpack")
    jcfg = PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12),
        em=EMConfig(rel_tol=1e-6, estimate_fld=False))
    JQuantifier(index, jcfg).quantify_files([fq1], [fq2], pack_cache=cache)
    jmeta = json.load(open(os.path.join(cache, "meta.json")))
    assert "build_id" not in jmeta
    bins = sorted(f for f in os.listdir(cache) if f.endswith(".bin"))
    jax_bytes = {f: open(os.path.join(cache, f), "rb").read() for f in bins}
    assert not tpc.cache_valid(cache, _cfg().map, [fq1], [fq2])
    with pytest.raises(ValueError, match="no build id"):
        tpc.PackCacheSource(cache, _cfg().map)
    fresh = _q(world).quantify_files([fq1], [fq2])
    rebuilt = _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    meta = json.load(open(os.path.join(cache, "meta.json")))
    assert meta["build_id"] and tpc.cache_valid(cache, _cfg().map, [fq1],
                                                [fq2])
    assert _key(rebuilt) == _key(fresh)
    # the layout but for the id is the JAX writer's, byte for byte
    assert {k: v for k, v in meta.items() if k != "build_id"} == jmeta
    assert sorted(f for f in os.listdir(cache) if f.endswith(".bin")) == bins
    for f in bins:
        assert open(os.path.join(cache, f), "rb").read() == jax_bytes[f], f


def test_cursor_kind_guards(world, tmp_path):
    _, _, fq1, fq2 = world
    cache = str(tmp_path / "gd.smpack")
    cfg = _cfg()
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    src = tpc.PackCacheSource(cache, cfg.map)
    pack_cursor = {"v": "pack1", "paired": True, "s1": [3, 0], "s2": None,
                   "pending": {}, "build": src.build_id}
    offset_cursor = {"v": 1, "paired": True, "s1": [0, 100],
                     "s2": [0, 100], "pending": {}}
    with pytest.raises(ValueError, match="pack-cache"):
        tfastq.CheckpointableBatchSource([fq1], [fq2], cfg.map).restore(
            pack_cursor)
    with pytest.raises(ValueError, match="file-offset"):
        src.restore(offset_cursor)
    with pytest.raises(ValueError, match="pairing"):
        src.restore(dict(pack_cursor, paired=False))


def test_short_or_missing_cache_file_raises(world, tmp_path):
    """A hit whose files are short or missing raises; it is not quietly
    rebuilt."""
    _, _, fq1, fq2 = world
    cache = str(tmp_path / "sh.smpack")
    _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    path = os.path.join(cache, next(f for f in sorted(os.listdir(cache))
                                    if f.startswith("c2_")))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-1])
    with pytest.raises(ValueError, match="holds"):
        _q(world).quantify_files([fq1], [fq2], pack_cache=cache)
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        _q(world).quantify_files([fq1], [fq2], pack_cache=cache)


def test_pack_cache_refuses_unpacked(world, tmp_path):
    _, _, fq1, fq2 = world
    cfg = _cfg()
    nope = cfg.replace(map=dataclasses.replace(cfg.map, h2d_pack_2bit=False))
    with pytest.raises(ValueError, match="no-h2d-pack"):
        _q(world, nope).quantify_files([fq1], [fq2],
                                       pack_cache=str(tmp_path / "x"))


def test_cache_with_fast_mode(world, tmp_path):
    """Cached 2-bit batches through fast mode: cached fast == fresh
    fast."""
    _, _, fq1, fq2 = world
    cache = str(tmp_path / "fm.smpack")
    fast = _cfg(probe_sample=4)
    fresh = _q(world, fast).quantify_files([fq1], [fq2])
    _q(world, fast).quantify_files([fq1], [fq2], pack_cache=cache)
    cached = _q(world, fast).quantify_files([fq1], [fq2], pack_cache=cache)
    assert _key(cached) == _key(fresh)


def test_default_cache_dir(world):
    """--pack-cache with no directory ("auto"): <first fastq>.smpack."""
    _, _, fq1, _ = world
    auto = os.path.abspath(fq1) + ".smpack"
    assert tpc.default_cache_dir([fq1]) == auto
    fresh = _q(world).quantify_files([fq1])
    built = _q(world).quantify_files([fq1], pack_cache="auto")
    assert tpc.cache_valid(auto, _cfg().map, [fq1], None)
    assert _key(built) == _key(fresh)
