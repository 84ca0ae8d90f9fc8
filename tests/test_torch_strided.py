"""Strided mode in the port: the plain ``lookup_ecs_strided`` against the
JAX function, the dense invariants, a numpy model of K7's tiles and queue
against the plain version, the port's ``Mapper`` with ``probe_stride``
against the JAX ``Mapper`` (single-end and paired, each mate its own
segment), the index's run-length aux column, and ``infer --probe-stride``.
Every stage is integer work: every comparison is exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu import encoding as jenc
from seekmer_tpu.config import IndexConfig as JIndexConfig
from seekmer_tpu.config import MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import ReadBatch as JReadBatch
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.ops.kmer_pack import pack_canonical as j_pack
from seekmer_tpu.ops.probe import device_table_layout as j_layout
from seekmer_tpu.ops.probe import lookup_ecs_strided as j_strided
from seekmer_tpu.utils.simulate import (
    isoform_transcriptome,
    random_transcriptome,
    simulate_packed_pairs,
    simulate_reads,
    write_fastq,
)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.index import build as tbuild
from seekmer_tpu_torch.io.fastq import ReadBatch
from seekmer_tpu_torch.map.driver import DeviceIndex, Mapper
from seekmer_tpu_torch.ops import probe, strided_cuda
from tests.test_torch_fast import _batches, _same_result
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    """tests/test_strided.py's world: 40 transcripts sharing prefixes."""
    rng = np.random.default_rng(13)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.6)
    return build_index_from_seqs(names, seqs), names, seqs


def _windows(index, seqs, read_len, error_rate, n=300, seed=5):
    """JAX-packed windows of simulated reads as numpy (hi, lo, valid)."""
    sim = simulate_reads(np.random.default_rng(seed), seqs, num_reads=n,
                         read_len=read_len, error_rate=error_rate)
    codes = np.full((n, read_len), 4, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, r in enumerate(sim.reads1):
        c = jenc.seq_to_codes(r)
        codes[i, :c.size] = c
        lengths[i] = c.size
    return tuple(np.asarray(a) for a in
                 j_pack(jnp.asarray(codes), jnp.asarray(lengths), index.k))


def _jax_geo(index):
    return (jnp.asarray(j_layout(index.table, index.bucket)),
            index.main_slots,
            jnp.asarray(j_layout(index.stash, index.bucket)),
            index.stash_slots, index.bucket)


def _geo(index):
    di = DeviceIndex.from_host(port_index(index), "cpu")
    return di.table, di.main_slots, di.stash, di.stash_slots, di.bucket


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# read lengths 100 and 97 give P = 76 and 73 windows at k = 25: P - 1 = 75
# is a multiple of no stride here, P - 1 = 72 of 2, 4 and 8 (the extra
# sample then repeats the last regular one)
@pytest.mark.parametrize("read_len", [100, 97])
@pytest.mark.parametrize("error_rate", [0.0, 0.02])
@pytest.mark.parametrize("stride", [2, 4, 8, 16])
def test_lookup_strided_matches_jax(world, stride, error_rate, read_len):
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, read_len, error_rate)
    want = np.asarray(j_strided(*(jnp.asarray(a) for a in (hi, lo, valid)),
                                *_jax_geo(index), stride))
    got = probe.lookup_ecs_strided(*_t(hi, lo, valid), *_geo(index), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if error_rate:  # some windows were looked up as needy, some filled
        assert (want[valid] >= 0).mean() < 1.0


@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("error_rate", [0.0, 0.02])
def test_strided_vs_dense_invariants(world, stride, error_rate):
    """tests/test_strided.py's invariants on the port: error-free, equal to
    dense; with errors, every dense hit equal, and divergences only fills
    over dense misses with an EC of the same read's dense hits."""
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, 100, error_rate)
    geo = _geo(index)
    dense = probe.lookup_ecs(*_t(hi, lo, valid), *geo).numpy()
    strided = probe.lookup_ecs_strided(*_t(hi, lo, valid), *geo,
                                       stride).numpy()
    v = valid
    if error_rate == 0.0:
        np.testing.assert_array_equal(strided[v], dense[v])
    hit = v & (dense >= 0)
    np.testing.assert_array_equal(strided[hit], dense[hit])
    div = v & (strided != dense)
    assert (dense[div] == -1).all() and (strided[div] >= 0).all()
    for b in np.unique(np.nonzero(div)[0]):
        read_ecs = set(dense[b][v[b] & (dense[b] >= 0)].tolist())
        assert set(strided[b][div[b]].tolist()) <= read_ecs
    assert (strided[~v] == -1).all()


def _k7_model(hi, lo, valid, geo, P, s, plan, warps, phase=0):
    """K7 (csrc/strided.cu) step by step in numpy on flat segments of P
    windows, under ``plan`` with ``warps`` warps walking the tiles
    grid-stride. Each warp stages a tile's valid run from the 16-byte chunk
    holding its first byte (``valid`` placed ``phase`` bytes past a 16-byte
    boundary) and its sampled windows' hi and lo in one of two buffers, the
    next tile's before the current one's work; the sampled lanes, 32 at a
    time, queue their slot behind the needy windows the warp's last tile
    left; rounds of the queue's last 32 tags (a stack); one partial round
    before the fill; the fill 4 windows a lane where P % 4 == 0 (an int4
    write) or one, -1 at needy windows until their round, the needy windows
    of a step queuing their offset in window order, then rounds while 32
    are queued; the warp's last tile drains the queue. A key's 3-state
    result is its ecaux (ec << AUX_BITS | d) when found, else -1. Returns
    (out, stats): stats counts the needy tags carried into a next tile, the
    partial rounds, the tiles and the short ones."""
    S, segs = plan.S, plan.segs
    n_seg = hi.size // P
    tiles = -(-n_seg // segs)
    warps = max(1, min(-(-tiles // 8), warps // 8)) * 8
    gvalid = np.zeros(phase + hi.size + 32, np.uint8)
    gvalid[phase:phase + hi.size] = valid
    out = np.full(hi.size, 999_999, np.int64)
    stats = dict(carried=0, partial=0, tiles=tiles, short=0)

    def lookup(keys):
        h, l_ = (torch.tensor([k[i] for k in keys], dtype=torch.int32)
                 for i in (0, 1))
        ec, aux = probe.lookup_ecs_aux(h, l_, torch.ones_like(h, dtype=bool),
                                       *geo)
        return np.where(ec.numpy() >= 0,
                        (ec.numpy() << probe.AUX_BITS) | aux.numpy(), -1)

    def ec_of(m):
        return m >> probe.AUX_BITS if m >= 0 else -1

    def tile_of(tile):
        T = min(segs, n_seg - tile * segs)
        return T, tile * segs * P

    def stage(tile):
        T, base = tile_of(tile)
        a = phase + base
        a0 = a & ~15
        chunks = (a + T * P - a0 + 15) >> 4
        assert 16 * chunks <= plan.hi_at  # the valid run fits its place
        cols = [(i // S) * P + min((i % S) * s, P - 1) for i in range(T * S)]
        assert 4 * T * S <= plan.lo_at - plan.hi_at
        return dict(v=gvalid[a0:a0 + 16 * chunks], at=a & 15,
                    hi=hi[base + np.array(cols, int)],
                    lo=lo[base + np.array(cols, int)])

    def flush(queue, buf, slot):  # a stack: the last 32 tags
        rest, batch = queue[:-32], queue[-32:]
        keys = [(buf["hi"][t], buf["lo"][t]) if t >= 0 else (hi[~t], lo[~t])
                for t in batch]
        for t, m in zip(batch, lookup(keys)):
            if t >= 0:
                slot[t] = m
            else:
                out[~t] = ec_of(m)
        if len(batch) < 32:
            stats["partial"] += 1
        return rest

    def fill_one(sl, col, v):
        gap = col // s
        pl, ml = gap * s, sl[gap]
        if col == P - 1:
            return ec_of(sl[S - 1]) if v else -1, False
        if col == pl:
            return ec_of(ml) if v else -1, False
        mr, pr = sl[gap + 1], min(pl + s, P - 1)
        cov_l = ml >= 0 and (ml & probe.AUX_MASK) >= col - pl
        cov_r = mr >= 0 and (mr & probe.AUX_MASK) >= pr - col
        need = v and not cov_l and not cov_r
        val = (ml >> probe.AUX_BITS if cov_l else
               mr >> probe.AUX_BITS if cov_r else -1)
        return (val if v and not need else -1), need

    for w in range(warps):
        queue, bufs = [], [None, None]
        mine = list(range(w, tiles, warps))
        if mine:
            bufs[0] = stage(mine[0])
        for j, tile in enumerate(mine):
            b = j & 1
            if j + 1 < len(mine):
                bufs[b ^ 1] = stage(mine[j + 1])
            buf = bufs[b]
            T, base = tile_of(tile)
            stats["short"] += T < segs
            stats["carried"] += len(queue)
            assert all(t < 0 for t in queue) and len(queue) < 32
            sv = buf["v"][buf["at"]:]
            slot = np.full(T * S, -7, np.int64)
            for q0 in range(0, T * S, 32):
                for i in range(q0, min(q0 + 32, T * S)):
                    slot[i] = -1
                    if sv[(i // S) * P + min((i % S) * s, P - 1)]:
                        queue.append(i)
                if len(queue) >= 32:
                    queue = flush(queue, buf, slot)
                assert len(queue) < 32
            if queue:
                queue = flush(queue, buf, slot)
            assert (slot != -7).all() and not queue
            width = 4 if P % 4 == 0 else 1
            for x0 in range(0, T * P, 32 * width):
                needy = []
                for x in range(x0, min(x0 + 32 * width, T * P), width):
                    t, col = divmod(x, P)
                    sl = slot[t * S:(t + 1) * S]
                    for k in range(width):
                        e, need = fill_one(sl, col + k, bool(sv[x + k]))
                        out[base + x + k] = e  # -1 at a needy window
                        if need:
                            needy.append(~(base + x + k))
                queue += needy  # in window order
                assert len(queue) <= strided_cuda.QUEUE
                while len(queue) >= 32:
                    queue = flush(queue, buf, slot)
            assert len(queue) < 32
        if queue:
            queue = flush(queue, None, None)
    return out, stats


def _plan(P, s, segs):
    """K7's plan with tiles of ``segs`` segments, the carve its own."""
    S = len(probe.strided_columns(P, s))
    return strided_cuda.StridedPlan(
        S, segs, strided_cuda.MIN_BLOCKS,
        *strided_cuda._carve(P, S, segs))


# (read_len, stride, segments, segs, phase): tiles of segs segments, 8
# warps walking them (each takes several and carries its needy keys across
# them), valid placed phase bytes past a 16-byte boundary
@pytest.mark.parametrize("read_len,stride,segments,segs,phase", [
    (100, 2, 1, 3, 0), (100, 16, 2, 4, 0), (97, 8, 2, 3, 3),
    (97, 3, 1, 2, 0), (26, 2, 2, 4, 1), (100, 4, 2, 5, 8),
    (101, 4, 1, 3, 5)],
    ids=["P76_s2_single", "P76_s16_paired", "P73_s8_paired", "P73_s3",
         "P2_s2_paired", "P76_s4_paired_phase8", "P77_s4_phase5"])
def test_k7_model_matches_plain(world, read_len, stride, segments, segs,
                                phase):
    """The numpy model of K7 equals the plain version (each segment on its
    own) on reads with errors, N runs and all-invalid rows, through the
    4-window fill (P % 4 == 0) and the scalar one; every window written,
    needy keys carried from a tile into the next one's sampled rounds, and
    a last tile shorter than the rest where the segments do not divide."""
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, read_len, 0.02, n=70)
    valid = valid.copy()
    valid[3] = False  # an all-invalid row
    valid[5, 10:40] = False  # a run of N bases
    B, P = hi.shape
    if segments == 2:  # pair rows up: row b's mates are reads 2b, 2b + 1
        hi, lo, valid = (a.reshape(B // 2, 2 * P) for a in (hi, lo, valid))
    geo = _geo(index)
    want = strided_cuda.lookup_ecs_strided(*_t(hi, lo, valid), *geo, stride,
                                           segments=segments).numpy()
    got, stats = _k7_model(hi.ravel(), lo.ravel(), valid.ravel(), geo, P,
                           stride, _plan(P, stride, segs), 8, phase)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    if P > 2:  # at P <= 2 every window is sampled
        assert stats["carried"] > 0  # needy keys crossed a tile boundary
    assert stats["tiles"] > 8  # a warp walks several tiles
    assert stats["short"] == int(B % segs > 0)


def test_k7_model_last_short_tile(world):
    """A batch whose segments the card's plan does not divide: the last
    tile is shorter, its staged run and samples are cut to it, and the
    model under the plan ``strided_plan`` gives equals the plain version."""
    index, _, seqs = world
    hi, lo, valid = _windows(index, seqs, 100, 0.02, n=67)
    P = hi.shape[1]
    geo = _geo(index)
    plan = strided_cuda.strided_plan(P, 4, 67, 1)
    assert 67 % plan.segs and -(-67 // plan.segs) >= 8
    want = strided_cuda.lookup_ecs_strided(*_t(hi, lo, valid), *geo,
                                           4).numpy()
    got, stats = _k7_model(hi.ravel(), lo.ravel(), valid.ravel(), geo, P, 4,
                           plan, 8, 7)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert stats["short"] == 1


def test_strided_plan():
    """Every plan fits its carve in a warp's share of shared memory at its
    blocks an SM (two staging buffers, each a tile's valid run from its
    16-byte chunk and its sampled hi and lo, then the slots and the
    queue), for P up to 1,024 and s from 2 to 64: S = ceil(P / s) + 1
    sampled columns; the tiles number at least the warps the card holds
    (SMs x blocks an SM x 8), and are the largest that do and fit."""
    for P in (1, 2, 31, 73, 76, 104, 488, 1024):
        for s in (2, 3, 4, 8, 16, 64):
            for n_seg, sms in ((131072, 132), (65536, 132), (70, 1),
                               (1, 132)):
                p = strided_cuda.strided_plan(P, s, n_seg, sms)
                resident = strided_cuda.resident_warps(sms, p.blocks)
                assert resident == sms * p.blocks * strided_cuda.WARPS
                assert p.S == len(probe.strided_columns(P, s))
                assert 1 <= p.blocks <= strided_cuda.MIN_BLOCKS
                n = 4 * p.segs * p.S
                assert p.hi_at >= ((p.segs * P + 30) & ~15)
                assert p.hi_at % 16 == 0 and p.stage % 16 == 0
                assert p.lo_at - p.hi_at >= n and p.stage - p.lo_at >= n
                assert p.slot_at >= 2 * p.stage
                assert p.queue_at - p.slot_at >= n
                assert p.warp_bytes - p.queue_at >= 4 * strided_cuda.QUEUE
                assert p.warp_bytes <= strided_cuda.warp_budget(p.blocks)
                assert (p.blocks * (strided_cuda.WARPS * p.warp_bytes
                                    + strided_cuda.BLOCK_RESERVED)
                        <= strided_cuda.SMEM_SM)
                tiles = -(-n_seg // p.segs)
                assert tiles >= min(resident, n_seg)  # every warp has one
                # the largest such tile that fits
                bigger = strided_cuda._carve(P, p.S, p.segs + 1)[-1]
                assert (bigger > strided_cuda.warp_budget(p.blocks)
                        or -(-n_seg // (p.segs + 1)) < resident
                        or n_seg // resident == p.segs)
    # the config-2 paired batch on 132 SMs x 4 blocks x 8 warps: tiles as
    # large as 4 blocks' 196 KB of shared memory takes
    for s, segs in ((16, 14), (8, 11), (4, 7), (2, 4)):
        p = strided_cuda.strided_plan(104, s, 131072, 132)
        assert (p.segs, p.blocks) == (segs, 4)
    with pytest.raises(ValueError):
        strided_cuda.strided_plan(1025, 4, 1, 1)


@pytest.mark.parametrize("stride", [2, 8])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_mapper_strided_matches_jax(paired, stride):
    """MapResult of the port's Mapper with probe_stride equal to the JAX
    Mapper's: signatures, counts, total, mapped, overflow, collisions."""
    rng = np.random.default_rng(43)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=700,
        shared_prefix_frac=0.6)
    sim = simulate_reads(rng, seqs, num_reads=300, read_len=90, paired=True,
                         mean_frag=180.0, error_rate=0.01)
    junk = ["".join(rng.choice(list("ACGTN"), size=90)) for _ in range(20)]
    index = build_index_from_seqs(names, seqs)
    cfg = MapConfig(batch_size=128, sig_table_bits=10, paired_end=paired,
                    probe_stride=stride, collision_audit_every=2)
    r1 = sim.reads1 + junk
    r2 = (sim.reads2 + junk[::-1]) if paired else None
    want = JMapper(index, cfg).run(_batches(r1, r2, cfg))
    got = Mapper(port_index(index), port_config(cfg), device="cpu").run(
        _batches(r1, r2, cfg))
    _same_result(got, want)
    assert got.total_reads == len(r1) and 0 < got.mapped < len(r1)


def test_paired_strided_map_step_matches_jax():
    """Paired strided mapping probes each mate as its own segment: with
    errors its MapResult equals the JAX Mapper's (which looks up each mate
    separately), and on error-free mates it equals dense mapping
    (tests/test_map_device.py ``test_paired_strided_matches_dense``)."""
    rng = np.random.default_rng(7)
    names, seqs, genes = isoform_transcriptome(rng, num_genes=12)
    index = build_index_from_seqs(names, seqs, genes=genes)
    L = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    sigs = {}
    for err in (0.0, 0.02):
        c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, 128, read_len=96,
                                          error_rate=err)
        for stride in (1, 3):
            cfg = MapConfig(batch_size=128, paired_end=True,
                            sig_table_bits=12, probe_stride=stride)
            jm = JMapper(index, cfg)
            jm.feed(JReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
            tm = Mapper(port_index(index), port_config(cfg), device="cpu")
            tm.feed(ReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
            got, want = tm.finalize(), jm.finalize()
            _same_result(got, want)
            sigs[err, stride] = {tuple(s.tolist()): int(n)
                                 for s, n in zip(got.sigs, got.sig_counts)}
    assert sigs[0.0, 1] == sigs[0.0, 3]


def test_run_length_aux_column_matches_jax(world):
    """The port's index copy writes the same aux column (the EC run
    lengths strided mode fills from) as the JAX package, from the same
    sequences, and the column is not empty."""
    index, names, seqs = world
    got = tbuild.build_index_from_seqs(names, seqs)
    for name in ("table", "stash"):
        a, b = getattr(got, name), getattr(index, name)
        np.testing.assert_array_equal(a[:, 3], b[:, 3], err_msg=name)
    occ = index.table[:, 0] != -1
    assert (index.table[occ, 3] > 0).mean() > 0.5
    assert port_config(JIndexConfig()).run_length_aux


def test_cli_probe_stride_reaches_the_config(world, tmp_path, monkeypatch):
    """``infer --probe-stride 4`` maps in strided mode: the flag reaches
    MapConfig, run_info.json records it, and the mapped count equals the
    JAX Mapper's strided run on the same reads."""
    from seekmer_tpu_torch.models import quantifier

    index, _, seqs = world
    sim = simulate_reads(np.random.default_rng(9), seqs, num_reads=400,
                         read_len=100, error_rate=0.01)
    fq, idx = str(tmp_path / "r.fq"), str(tmp_path / "index.npz")
    write_fastq(fq, sim.reads1)
    index.save(idx)
    seen = []
    real = quantifier.Quantifier.__init__

    def spy(self, index, cfg, device="cuda", **kw):
        seen.append(cfg.map)
        real(self, index, cfg, device=device, **kw)

    monkeypatch.setattr(quantifier.Quantifier, "__init__", spy)
    out = str(tmp_path / "out")
    assert cli.main(["infer", idx, out, fq, "--device", "cpu",
                     "--batch-size", "256", "--probe-stride", "4"]) == 0
    assert seen[0].probe_stride == 4
    info = json.load(open(os.path.join(out, "run_info.json")))
    assert info["probe_stride"] == 4 and info["probe_sample"] == 0
    assert info["kernel_launches"]["strided"] == 0  # CPU: no kernel
    cfg = MapConfig(batch_size=256, probe_stride=4)
    want = JMapper(index, cfg).run(_batches(sim.reads1, None, cfg))
    assert info["total_reads"] == want.total_reads
    assert 0 < info["mapped"] <= want.mapped
