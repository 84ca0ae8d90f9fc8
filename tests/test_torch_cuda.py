"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (sm_90a) and nvcc, and skips without
them. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the tests directory's conftest sets up JAX, which the
card's machine does not have). This file imports nothing of JAX nor of
``seekmer_tpu``: the reference on the card is the port's own plain version.
"""

import numpy as np
import pytest
import torch

from seekmer_tpu_torch import encoding as enc
from seekmer_tpu_torch.config import EMConfig, IndexConfig, MapConfig
from seekmer_tpu_torch.index.build import build_index_from_seqs
from seekmer_tpu_torch.io.fastq import ReadBatch
from seekmer_tpu_torch.map.driver import DeviceIndex, Mapper, merge_sig_rows
from seekmer_tpu_torch.map.signature import make_sig_table, table_to_host
from seekmer_tpu_torch.ops import (
    accumulate_cuda,
    em_cuda,
    em_dense,
    pack_cuda,
    probe_cuda,
    sig_cuda,
)
from seekmer_tpu_torch.ops.probe import device_table_layout
from seekmer_tpu_torch.utils.simulate import (
    random_transcriptome,
    simulate_packed_batches,
    simulate_packed_pairs,
)
from tests.synthetic_buckets import (check_expected, hi_collision_tables,
                                     query_lanes)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full FP32 products in the plain versions, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    names, seqs = random_transcriptome(
        rng, num_transcripts=200, min_len=150, max_len=1500,
        shared_prefix_frac=0.5)
    return rng, seqs, {
        "default": build_index_from_seqs(names, seqs),
        "stash": build_index_from_seqs(names, seqs,
                                       cfg=IndexConfig(bucket_size=4)),
    }


def _eq(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


def _pack_inputs(dev, B, L, k, seed):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[r.random((B, L)) < 0.02] = 4
    lengths = r.integers(max(k - 2, 0), L + 1, size=B).astype(np.int32)
    for i, n in enumerate(lengths):
        codes[i, n:] = 4
    packed, bad = (torch.from_numpy(a).to(dev)
                   for a in enc.pack_codes_2bit(codes))
    return packed, bad, torch.from_numpy(lengths).to(dev)


# L = 70, 101 and 37 are not multiples of 8 (nor 70 and 37 of 4): rows
# start off 16-byte boundaries, which the kernel's staging must handle
@pytest.mark.parametrize("k,L", [(25, 128), (29, 70), (21, 512), (25, 101),
                                 (3, 37), (1, 9)])
def test_pack_kernel(dev, k, L):
    packed, bad, ln = _pack_inputs(dev, 3000, L, k, seed=k)
    before = pack_cuda.pack_canonical_2bit.launches
    got = pack_cuda.pack_canonical_2bit(packed, bad, ln, L, k)
    torch.cuda.synchronize()
    assert pack_cuda.pack_canonical_2bit.launches == before + 1
    for g, w in zip(got, pack_cuda.plain(packed, bad, ln, L, k)):
        _eq(g, w)


@pytest.mark.parametrize("k,L", [(25, 128), (25, 101), (3, 37)])
def test_pack_kernel_out_and_offset(dev, k, L):
    """Two mates written into one (B, 2P) output equal the plain version
    filling the same slices, and the concatenation of separate calls."""
    B, P = 2999, L - k + 1
    mates = [_pack_inputs(dev, B, L, k, seed=s) for s in (1, 2)]
    outs = []
    for fn in (pack_cuda.pack_canonical_2bit, pack_cuda.plain):
        out = (torch.full((B, 2 * P), 7, dtype=torch.int32, device=dev),
               torch.full((B, 2 * P), 7, dtype=torch.int32, device=dev),
               torch.zeros((B, 2 * P), dtype=torch.bool, device=dev))
        for i, m in enumerate(mates):
            assert fn(*m, L, k, out=out, offset=i * P) is out
        outs.append(out)
    apart = [pack_cuda.pack_canonical_2bit(*m, L, k) for m in mates]
    torch.cuda.synchronize()
    for g, w, a, b in zip(*outs, *apart):
        _eq(g, w)
        _eq(g, torch.cat([a, b], dim=1))


@pytest.mark.parametrize("which", ["default", "stash"])
def test_lookup_kernel(dev, world, which):
    rng, seqs, idx = world
    index = idx[which]
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    B, L = 2048, 128
    codes, _ = simulate_packed_batches(rng, seqs, 1, B, read_len=100,
                                       error_rate=0.02)
    padded = np.full((B, L), 4, np.uint8)
    padded[:, :100] = codes[0]
    packed, bad = (torch.from_numpy(a).to(dev)
                   for a in enc.pack_codes_2bit(padded))
    hi, lo, valid = pack_cuda.pack_canonical_2bit(
        packed, bad, torch.full((B,), 100, dtype=torch.int32, device=dev),
        L, index.k)
    lanes = [(hi, lo, valid)]
    for table in (index.table, index.stash):  # every stored key
        occ = table[table[:, 0] != -1]
        v = torch.ones(occ.shape[0], dtype=torch.bool, device=dev)
        v[::5] = False
        lanes.append((torch.from_numpy(occ[:, 0].copy()).to(dev),
                      torch.from_numpy(occ[:, 1].copy()).to(dev), v))
    absent = rng.integers(0, 1 << 30, (2, 100000), dtype=np.int32)
    lanes.append((torch.from_numpy(absent[0]).to(dev),
                  torch.from_numpy(absent[1]).to(dev),
                  torch.ones(100000, dtype=torch.bool, device=dev)))
    for h, l, v in lanes:
        got = probe_cuda.lookup_ecs_aux(h, l, v, *geo)
        want = probe_cuda.plain(h, l, v, *geo)
        torch.cuda.synchronize()
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    if which == "stash":
        assert index.stash[:, 0].max() >= 0  # stash keys were exercised


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_lookup_kernel_hi_collisions(dev, G):
    """Synthetic buckets whose slots share a key's hi but not its lo (the
    true key behind two such slots, a full row sending the key to the
    stash, a row with an empty slot keeping it MISS though the stash holds
    it), at every bucket size the kernel takes."""
    table, stash, queries = hi_collision_tables(G, seed=G)
    hi, lo, valid = (torch.from_numpy(a).to(dev) for a in query_lanes(queries))
    geo = (torch.from_numpy(device_table_layout(table, G)).to(dev),
           table.shape[0],
           torch.from_numpy(device_table_layout(stash, G)).to(dev),
           stash.shape[0], G)
    got = probe_cuda.lookup_ecs_aux(hi, lo, valid, *geo)
    want = probe_cuda.plain(hi, lo, valid, *geo)
    torch.cuda.synchronize()
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    check_expected(queries, got[0].cpu().numpy(), got[1].cpu().numpy())


@pytest.mark.parametrize("B,P,C", [(4099, 208, 16), (1000, 976, 16),
                                   (777, 30, 5), (64, 3, 8)])
def test_signature_kernel(dev, B, P, C):
    r = np.random.default_rng(P)
    ecs = r.integers(-1, 3 * C, size=(B, P)).astype(np.int32)
    ecs[: B // 3] = r.integers(-1, 4, size=(B // 3, P))  # few distinct
    ecs[B // 3: B // 3 + 5] = -1  # no hits
    valid = torch.from_numpy(r.random((B, P)) < 0.9).to(dev)
    e = torch.from_numpy(ecs).to(dev)
    got = sig_cuda.read_signatures(e, valid, C)
    want = sig_cuda.plain(e, valid, C)
    torch.cuda.synchronize()
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert bool(got[1].any()) and not bool(got[1].all())


def _merged(table, total):
    s, c = table_to_host(table)
    return merge_sig_rows(s, c, total, int(table.overflow),
                          int(table.collisions))


def _paired_signatures(dev, rng, seqs, di, B, C):
    """Signatures of B simulated read pairs through K1, K2 and K3."""
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, B, read_len=100)
    ln = torch.full((B,), 100, dtype=torch.int32, device=dev)
    mates = []
    for c in (c1[0], c2[0]):
        packed, bad = (torch.from_numpy(a).to(dev)
                       for a in enc.pack_codes_2bit(c))
        mates.append(pack_cuda.pack_canonical_2bit(packed, bad, ln, 100,
                                                   di.k))
    hi, lo, valid = (torch.cat([mates[0][i], mates[1][i]], dim=1)
                     for i in range(3))
    ecs = probe_cuda.lookup_ecs(hi, lo, valid, di.table, di.main_slots,
                                di.stash, di.stash_slots, di.bucket)
    return sig_cuda.read_signatures(ecs, valid, C)


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "cas_only"])
def test_accumulate_kernel(dev, world, direct):
    """Three batches folded by the kernel and by the plain version: equal
    merged counts and the same fingerprints in the key table."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    C = 16
    tables = [make_sig_table(12, C, num_ecs=index.num_ecs if direct else 0,
                             device=dev) for _ in range(2)]
    for batch in range(3):
        sig, mapped = _paired_signatures(dev, rng, seqs, di, 4096, C)
        w = torch.from_numpy(
            (rng.random(4096) < 0.97).astype(np.int32)).to(dev)
        audit = batch != 1
        accumulate_cuda.fold_batch(tables[0], sig, mapped, weights=w,
                                   audit=audit)
        accumulate_cuda.plain(tables[1], sig, mapped, weights=w, audit=audit)
    torch.cuda.synchronize()
    a, b = (_merged(t, 0) for t in tables)
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.overflow, a.collisions) == (b.overflow, b.collisions) == (0, 0)
    keys = [np.sort(t.key.view(torch.int64).cpu().numpy().ravel())
            for t in tables]
    np.testing.assert_array_equal(keys[0], keys[1])


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_mapper_on_card_matches_cpu(dev, world, paired):
    rng, seqs, idx = world
    index = idx["default"]
    B, L = 1024, 100
    if paired:
        c1, c2, _ = simulate_packed_pairs(rng, seqs, 3, B, read_len=L)
    else:
        c1, _ = simulate_packed_batches(rng, seqs, 3, B, read_len=L)
    ln = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], ln, w, codes2=c2[i] if paired else None,
                         lengths2=ln if paired else None) for i in range(3)]
    cfg = MapConfig(batch_size=B, sig_table_bits=14, paired_end=paired)
    counts = [f.launches for f in (pack_cuda.pack_canonical_2bit,
                                   probe_cuda.lookup_ecs_aux,
                                   sig_cuda.read_signatures,
                                   accumulate_cuda.fold_batch)]
    got = Mapper(index, cfg, device=dev).run(batches)
    after = [f.launches for f in (pack_cuda.pack_canonical_2bit,
                                  probe_cuda.lookup_ecs_aux,
                                  sig_cuda.read_signatures,
                                  accumulate_cuda.fold_batch)]
    assert [x - y for x, y in zip(after, counts)] == [
        3 * (2 if paired else 1), 3, 3, 3]
    want = Mapper(index, cfg, device="cpu").run(batches)
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.mapped, got.overflow, got.collisions) == (
        want.mapped, want.overflow, want.collisions)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    ecs = torch.zeros((8, 40), dtype=torch.int32, device=dev)[:, ::2]
    valid = torch.ones((8, 20), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        sig_cuda.read_signatures(ecs, valid, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sig_cuda.read_signatures(ecs.contiguous(), valid.cpu(), 4)


def test_quantifier_on_card_matches_cpu(dev, world, tmp_path):
    """The library entry point end to end (ingest, pinned upload, kernels,
    EM on the card) against the same run on the CPU."""
    from seekmer_tpu_torch.config import PipelineConfig
    from seekmer_tpu_torch.models.quantifier import Quantifier
    from seekmer_tpu_torch.utils.simulate import simulate_reads, write_fastq

    rng, seqs, idx = world
    sim = simulate_reads(rng, seqs, num_reads=3000, read_len=100,
                         error_rate=0.005)
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, sim.reads1)
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=1024, sig_table_bits=14),
        em=EMConfig(rel_tol=1e-6, max_iters=2000, use_x64=True))
    got = Quantifier(idx["default"], cfg, device="cuda").quantify_files([fq])
    want = Quantifier(idx["default"], cfg, device="cpu").quantify_files([fq])
    assert (got.total_reads, got.mapped, got.em_iterations) == (
        want.total_reads, want.mapped, want.em_iterations)
    # float64 EM; only the atomics' summation order differs
    np.testing.assert_allclose(got.est_counts, want.est_counts, rtol=1e-9,
                               atol=1e-9)


def _em_system(dev, T, E, R, seed):
    """A random dense EM system on the card: M [E, T] with 1-5 members per
    EC, counts n [R, E], inv_eff [T], alpha0 [R, T] (float32)."""
    rng = np.random.default_rng(seed)
    M = np.zeros((E, T), np.float32)
    for e in range(E):
        M[e, rng.choice(T, size=int(rng.integers(1, 6)), replace=False)] = 1
    n = rng.integers(0, 500, size=(R, E)).astype(np.float32)
    eff = rng.integers(50, 3000, size=T).astype(np.float32)
    alpha0 = np.repeat(n.sum(axis=1, keepdims=True) / T, T, axis=1)
    return [torch.from_numpy(a).to(dev) for a in
            (M, n, (1.0 / eff).astype(np.float32), alpha0.astype(np.float32))]


def _groups(M):
    """Group id per transcript: transcripts with identical EC membership
    are EM-degenerate, so only their summed mass is determined."""
    return torch.unique(M.t(), dim=0, return_inverse=True)[1]


@pytest.mark.parametrize("T,E,R", [(60, 150, 1), (60, 150, 8),
                                   (1000, 1396, 1), (1000, 1396, 8),
                                   (1000, 1396, 100)])
def test_em_kernel(dev, T, E, R):
    """K4 against its plain version (torch.matmul in FP32): iteration counts
    within one check_every block, group masses within rtol 1e-3 (atol 1e-2
    reads), every replicate's mass kept."""
    M, n, inv_eff, alpha0 = _em_system(dev, T, E, R, seed=T + R)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    before = em_cuda.em_fixed_point.launches
    got, it = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    torch.cuda.synchronize()
    assert em_cuda.em_fixed_point.launches == before + 1
    want, it_p = em_dense.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    assert got.shape == (R, T) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert abs(it - it_p) <= cfg.check_every and it % cfg.check_every == 0
    g = _groups(M)
    G = int(g.max()) + 1
    gs = [torch.zeros((R, G), device=dev).index_add_(1, g, a)
          for a in (got, want)]
    torch.testing.assert_close(gs[0], gs[1], rtol=1e-3, atol=1e-2)
    live = (M.sum(dim=1) > 0)[None, :]
    mass = torch.where(live, n, 0.0).sum(dim=1)
    torch.testing.assert_close(got.sum(dim=1), mass, rtol=1e-4, atol=1e-3)


def test_em_kernel_deterministic_and_budgeted(dev):
    """Two runs give the same bits; max_iters and min_iters bound the
    count as in the plain version."""
    M, n, inv_eff, alpha0 = _em_system(dev, 1000, 1396, 100, seed=3)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    a, ia = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    b, ib = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    assert ia == ib and torch.equal(a, b)
    capped = EMConfig(rel_tol=0.0, max_iters=40, check_every=16)
    _, it = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, capped)
    assert it == em_dense.em_fixed_point(M, n, inv_eff, alpha0, capped)[1]
    assert it == 48
    loose = EMConfig(rel_tol=1.0, min_iters=100, check_every=7)
    _, it = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, loose)
    assert it == em_dense.em_fixed_point(M, n, inv_eff, alpha0, loose)[1]
    assert it >= 100 and it % 7 == 0


@pytest.mark.parametrize("E,T,R", [(7600, 250, 8), (100, 14400, 8)])
def test_em_kernel_near_gate_walks_depth_chunks(dev, E, T, R):
    """Systems at the dense gate's edge, E-deep (7,600 x 250 pads to 1.97M
    of the gate's 2M entries) and T-deep (100 x 14,400 pads to 128 x
    14,464, the widest T the gate admits at R 8), every transcript in
    some EC, whose depth does not fit in shared memory: K4 walks it in
    chunks, holds the plain version's iteration count and group masses,
    and gives the same bits twice."""
    assert em_dense.fits_dense(E, T, R)
    plan = em_cuda.plan(E, T, R, dev)
    assert 0 < plan["KC"] < plan["cluster"] * max(plan["SE"], plan["ST"])
    M, n, inv_eff, alpha0 = _em_system(dev, T, E, R, seed=7)
    cols = np.random.default_rng(7).integers(0, E, size=T)
    M[torch.from_numpy(cols).to(dev), torch.arange(T, device=dev)] = 1.0
    cfg = EMConfig(rel_tol=1e-6, max_iters=400)
    got, it = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    again, it2 = em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    assert it == it2 and torch.equal(got, again)
    want, it_p = em_dense.em_fixed_point(M, n, inv_eff, alpha0, cfg)
    assert abs(it - it_p) <= cfg.check_every
    g = _groups(M)
    G = int(g.max()) + 1
    gs = [torch.zeros((R, G), device=dev).index_add_(1, g, a)
          for a in (got, want)]
    torch.testing.assert_close(gs[0], gs[1], rtol=1e-3, atol=1e-2)


def test_em_kernel_never_falls_back(dev):
    """What the kernel does not take raises on the card; nothing moves to
    the plain version or the CPU."""
    M, n, inv_eff, alpha0 = _em_system(dev, 60, 150, 8, seed=4)
    cfg = EMConfig()
    before = em_cuda.em_fixed_point.launches
    with pytest.raises(ValueError, match="float32"):
        em_cuda.em_fixed_point(M.double(), n.double(), inv_eff.double(),
                               alpha0.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        em_cuda.em_fixed_point(M, n, inv_eff, alpha0.t().contiguous().t(),
                               cfg)
    with pytest.raises(ValueError, match="CUDA"):
        em_cuda.em_fixed_point(M, n.cpu(), inv_eff, alpha0, cfg)
    with pytest.raises(ValueError, match="shapes"):
        em_cuda.em_fixed_point(M, n[:, :-1], inv_eff, alpha0, cfg)
    assert em_cuda.em_fixed_point.launches == before


def test_bootstrap_on_card_takes_k4(dev):
    """run_bootstrap on a system under the dense gate launches K4 once;
    each replicate keeps the resample's mass."""
    from seekmer_tpu_torch.em.bootstrap import run_bootstrap
    from seekmer_tpu_torch.em.em import build_ec_table

    rng = np.random.default_rng(6)
    T, E = 200, 400
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 5)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 300, size=E).astype(np.float64)
    lengths = rng.integers(300, 3000, size=T).astype(np.int32)
    ec = build_ec_table(members, counts, T, device=dev)
    cfg = EMConfig(rel_tol=1e-5, bootstrap_samples=16, bootstrap_seed=2)
    before = em_cuda.em_fixed_point.launches
    boot, it = run_bootstrap(ec, lengths, cfg)
    assert em_cuda.em_fixed_point.launches == before + 1
    assert boot.shape == (16, T) and boot.device.type == "cuda"
    torch.testing.assert_close(boot.sum(dim=1).cpu(),
                               torch.full((16,), counts.sum(),
                                          dtype=torch.float32),
                               rtol=1e-4, atol=0.0)
    again, _ = run_bootstrap(ec, lengths, cfg)
    assert torch.equal(boot, again)
