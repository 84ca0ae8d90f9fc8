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
from seekmer_tpu_torch.map.signature import (SIG_PAD, make_sig_table,
                                             table_to_host)
from seekmer_tpu_torch.map.driver import map_step
from seekmer_tpu_torch.ops import (
    accumulate_cuda,
    em_cuda,
    em_dense,
    fast_cuda,
    pack_cuda,
    probe,
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
from tests.synthetic_signatures import adversarial_rows, seed_collision

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


def _paired_lanes(dev, rng, seqs, di, B):
    """(ecs, valid) [B, 2P] of B simulated read pairs through K1 and K2."""
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
    return ecs, valid


def _paired_signatures(dev, rng, seqs, di, B, C):
    """Signatures of B simulated read pairs through K1, K2 and K3."""
    return sig_cuda.read_signatures(*_paired_lanes(dev, rng, seqs, di, B), C)


def _check_signatures(ecs, valid, C):
    got = sig_cuda.read_signatures(ecs, valid, C)
    want = sig_cuda.plain(ecs, valid, C)
    torch.cuda.synchronize()
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    return got


def test_signature_kernel_paired_reads(dev, world):
    """K3 on the run-structured rows of simulated read pairs, as the map
    step hands them over; each mate's padded tail is invalid."""
    rng, seqs, idx = world
    di = DeviceIndex.from_host(idx["default"], dev)
    ecs, valid = _paired_lanes(dev, rng, seqs, di, 8192)
    before = sig_cuda.read_signatures.launches
    sig, mapped = _check_signatures(ecs, valid, 16)
    assert sig_cuda.read_signatures.launches == before + 1
    assert float(mapped.float().mean()) > 0.8


@pytest.mark.parametrize("P,C", [(208, 16), (976, 16), (1024, 16),
                                 (101, 16), (30, 5), (3, 8), (64, 40)])
def test_signature_kernel_adversarial_rows(dev, P, C):
    """The rows of tests/synthetic_signatures.py (32 and 33 run heads, ids
    recurring after a miss, every window a head, ...) repeated over many
    reads, so one launch takes both of the kernel's paths; at P = 208 and
    976 (W 256 and 1,024) the > 32-head path sorts the whole row in
    registers. Rows off a 16-byte boundary take the one-window loads."""
    ecs, valid = adversarial_rows(P, C, seed=P + C)
    reps = 4096 // ecs.shape[0] + 1
    e = torch.from_numpy(np.tile(ecs, (reps, 1))).to(dev)
    v = torch.from_numpy(np.tile(valid, (reps, 1))).to(dev)
    _check_signatures(e, v, C)
    if P % 4 == 0:
        B = e.shape[0]
        buf = torch.empty(B * P + 1, dtype=torch.int32, device=dev)
        off = buf[1:].view(B, P)
        off.copy_(e)
        _check_signatures(off, v, C)


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


def _fold_both(tables, sig, mapped, weights, audit):
    accumulate_cuda.fold_batch(tables[0], sig, mapped, weights=weights,
                               audit=audit)
    accumulate_cuda.plain(tables[1], sig, mapped, weights=weights,
                          audit=audit)
    torch.cuda.synchronize()


def _same_tables(tables):
    a, b = (_merged(t, 0) for t in tables)
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.overflow, a.collisions) == (b.overflow, b.collisions)
    keys = [np.sort(t.key.view(torch.int64).cpu().numpy().ravel())
            for t in tables]
    np.testing.assert_array_equal(keys[0], keys[1])
    return a


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "cas_only"])
def test_accumulate_kernel_forced_collision(dev, world, direct):
    """A table pre-seeded with a colliding key for one multi-EC signature of
    the batch: the audit (of the reads that matched a key) counts the same
    collisions as the plain version's, and they are > 0."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    C = 16
    sig, mapped = _paired_signatures(dev, rng, seqs, di, 4096, C)
    multi = mapped & (sig[:, 1] != SIG_PAD)
    assert bool(multi.any())
    tables = [make_sig_table(12, C, num_ecs=index.num_ecs if direct else 0,
                             device=dev) for _ in range(2)]
    for t in tables:
        seed_collision(t, sig[multi][0])
    w = torch.from_numpy(rng.integers(0, 3, size=4096).astype(np.int32)).to(
        dev)
    for audit in (True, False, True):
        _fold_both(tables, sig, mapped, w, audit)
    res = _same_tables(tables)
    assert res.collisions > 0


@pytest.mark.parametrize("audit", [True, False], ids=["audit", "no_audit"])
@pytest.mark.parametrize("weights", ["ones", "none", "zero"])
def test_accumulate_kernel_steady_state(dev, world, audit, weights):
    """The batch already in the table (every multi-EC read matches, none
    claims), with the audit on and off, with weights, without, and with
    all weights zero."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    C = 16
    sig, mapped = _paired_signatures(dev, rng, seqs, di, 4096, C)
    tables = [make_sig_table(12, C, num_ecs=index.num_ecs, device=dev)
              for _ in range(2)]
    _fold_both(tables, sig, mapped, None, True)
    w = {"ones": torch.ones(4096, dtype=torch.int32, device=dev),
         "none": None,
         "zero": torch.zeros(4096, dtype=torch.int32, device=dev)}[weights]
    first = _merged(tables[0], 0)
    for _ in range(3):
        _fold_both(tables, sig, mapped, w, audit)
    res = _same_tables(tables)
    assert res.collisions == 0
    if weights == "zero":
        np.testing.assert_array_equal(res.sig_counts, first.sig_counts)
    else:
        np.testing.assert_array_equal(res.sig_counts, 4 * first.sig_counts)


@pytest.mark.parametrize("C", [1, 5, 64])
def test_accumulate_kernel_row_widths(dev, C):
    """Rows the kernel stages one int32 at a time (C = 1, 5) and rows whose
    block of 256 staged rows needs more than 48 KB of shared memory (C =
    64), with the audit on and off, against the plain version."""
    rng = np.random.default_rng(C)
    B = 5000
    pool = np.full((300, C), SIG_PAD, np.int32)
    for i in range(300):
        n = int(rng.integers(1, min(C, 6) + 1))
        pool[i, :n] = np.sort(rng.choice(100, size=n, replace=False))
    sig = torch.from_numpy(pool[rng.integers(0, 300, size=B)]).to(dev)
    mapped = torch.from_numpy(rng.random(B) < 0.95).to(dev)
    for num_ecs in (100, 0):
        tables = [make_sig_table(12, C, num_ecs=num_ecs, device=dev)
                  for _ in range(2)]
        for audit in (True, False):
            _fold_both(tables, sig, mapped, None, audit)
        _same_tables(tables)


def test_accumulate_kernel_in_passes(dev):
    """A batch larger than the card holds at once in one cooperative launch
    (the audit on) goes round in passes, one grid barrier each."""
    rng = np.random.default_rng(9)
    B, C = 600_000, 16
    pool = np.full((5000, C), SIG_PAD, np.int32)
    for i in range(5000):
        n = int(rng.integers(1, 6))
        pool[i, :n] = np.sort(rng.choice(400, size=n, replace=False))
    sig = torch.from_numpy(pool[rng.integers(0, 5000, size=B)]).to(dev)
    mapped = torch.from_numpy(rng.random(B) < 0.95).to(dev)
    tables = [make_sig_table(16, C, num_ecs=400, device=dev)
              for _ in range(2)]
    x = sig[sig[:, 1] != SIG_PAD][0]
    for t in tables:
        seed_collision(t, x)
    for _ in range(2):
        _fold_both(tables, sig, mapped, None, True)
    res = _same_tables(tables)
    assert res.overflow == 0 and res.collisions > 0


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


# ---- fast mode: K5 (sample + probe + classify) and K6 (merge) ---------------


def _fast_mates(dev, rng, seqs, B, L, n_seg):
    """(packed, bad, lengths) on the card of each segment: simulated 100 bp
    reads with 2% errors, a share of junk rows (no indexed k-mer), N bases,
    ragged lengths, and in the last segment an all-invalid row every 97."""
    mates = []
    for g in range(n_seg):
        codes, _ = simulate_packed_batches(rng, seqs, 1, B, read_len=100,
                                           error_rate=0.02)
        padded = np.full((B, L), 4, np.uint8)
        padded[:, :100] = codes[0]
        dead = rng.random(B) < 0.2
        padded[dead, :100] = rng.integers(0, 4, size=(int(dead.sum()), 100))
        padded[rng.random((B, L)) < 0.005] = 4
        lengths = rng.integers(20, 101, size=B).astype(np.int32)
        lengths[rng.random(B) < 0.5] = 100
        if g == n_seg - 1:
            padded[::97] = 4
        packed, bad = enc.pack_codes_2bit(padded)
        mates.append(tuple(torch.from_numpy(a).to(dev)
                           for a in (packed, bad, lengths)))
    return mates


def _check_sample(mates, L, k, stride, geo):
    """K5 against the plain sample_classify: the same single ECs, the same
    units (each unit's rows found through its slot on both sides)."""
    before = fast_cuda.sample_classify.launches
    got = fast_cuda.sample_classify(mates, L, k, stride, *geo)
    want = probe.sample_classify(mates, L, k, stride, *geo)
    torch.cuda.synchronize()
    assert fast_cuda.sample_classify.launches == before + 1
    _eq(got[0], want[0])
    _eq(got[1] >= 0, want[1] >= 0)
    has = got[1] >= 0
    assert got[2][0].shape[0] == want[2][0].shape[0] == int(has.sum())
    for g_rows, w_rows in zip(got[2], want[2]):
        _eq(g_rows[got[1][has].long()], w_rows[want[1][has].long()])
    # every unit has its own slot
    assert torch.equal(torch.sort(got[1][has]).values,
                       torch.arange(int(has.sum()), device=has.device,
                                    dtype=torch.int32))
    return got, want


@pytest.mark.parametrize("which", ["default", "stash"])
@pytest.mark.parametrize("stride", [2, 16])
@pytest.mark.parametrize("n_seg", [1, 2], ids=["single", "paired"])
def test_sample_kernel(dev, world, which, stride, n_seg):
    """K5 on reads with errors, junk, N bases, ragged lengths and
    all-invalid mates; the "stash" index (4-slot buckets) puts keys of the
    sampled windows in the stash."""
    rng, seqs, idx = world
    index = idx[which]
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    L = 128
    mates = _fast_mates(dev, rng, seqs, 3000, L, n_seg)
    got, _ = _check_sample(mates, L, index.k, stride, geo)
    nu = got[2][0].shape[0]
    assert 0 < nu < 3000 * n_seg
    if which == "stash":  # some sampled window's key lives in the stash
        cols = probe.sample_columns(L - index.k + 1, stride)
        hi, lo, valid = pack_cuda.plain(*mates[0], L, index.k)
        keys = (hi[:, cols][valid[:, cols]].long() << 32) | (
            lo[:, cols][valid[:, cols]].long() & 0xFFFFFFFF)
        occ = index.stash[index.stash[:, 0] != -1]
        stash_keys = torch.from_numpy((occ[:, 0].astype(np.int64) << 32)
                                      | (occ[:, 1].astype(np.int64)
                                         & 0xFFFFFFFF)).to(dev)
        assert bool(torch.isin(keys, stash_keys).any())


def test_sample_kernel_no_unit_and_every_unit(dev):
    """Nu = 0: a one-transcript world where every read resolves in phase
    1, and fast mode launches nothing of phase 2. Nu = every unit: junk
    reads, every segment of which is re-probed."""
    rng = np.random.default_rng(12)
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    index = build_index_from_seqs(["t0"], [seq])
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    L, B = 128, 2000
    codes, _ = simulate_packed_batches(rng, [seq], 1, B, read_len=100,
                                       error_rate=0.0)
    padded = np.full((B, L), 4, np.uint8)
    padded[:, :100] = codes[0]
    clean = [tuple(torch.from_numpy(a).to(dev)
                   for a in (*enc.pack_codes_2bit(padded),
                             np.full(B, 100, np.int32)))]
    got, _ = _check_sample(clean, L, index.k, 16, geo)
    assert got[2][0].shape[0] == 0 and bool((got[1] == -1).all())
    counts = [f.launches for f in (pack_cuda.pack_canonical_2bit,
                                   probe_cuda.lookup_ecs_aux,
                                   sig_cuda.read_signatures)]
    sig, mapped = fast_cuda.two_phase_signatures(clean, L, index.k, 16, 16,
                                                 *geo)
    assert [f.launches for f in (pack_cuda.pack_canonical_2bit,
                                 probe_cuda.lookup_ecs_aux,
                                 sig_cuda.read_signatures)] == counts
    want = probe.two_phase_signatures(clean, L, index.k, 16, 16, *geo)
    _eq(sig, want[0])
    _eq(mapped, want[1])
    assert bool(mapped.all())

    junk = np.full((B, L), 4, np.uint8)
    junk[:, :100] = rng.integers(0, 4, size=(B, 100))
    mates = [tuple(torch.from_numpy(a).to(dev)
                   for a in (*enc.pack_codes_2bit(junk),
                             np.full(B, 100, np.int32)))] * 2
    got, _ = _check_sample(mates, L, index.k, 16, geo)
    assert got[2][0].shape[0] == 2 * B


def _merge_inputs(dev, B, n_seg, C, nu_share, seed):
    r = np.random.default_rng(seed)
    single = np.where(r.random((B, n_seg)) < 0.7,
                      r.integers(0, 40, (B, n_seg)), SIG_PAD).astype(np.int32)
    need = r.random((B, n_seg)) < nu_share
    single[need] = SIG_PAD
    nu = int(need.sum())
    slot = np.full((B, n_seg), -1, np.int32)
    slot[need] = r.permutation(nu)
    sig_d = np.full((nu, C), SIG_PAD, np.int32)
    mapped_d = np.zeros(nu, bool)
    for u in range(nu):
        n = int(r.integers(0, C + 3))  # empty, mapped and complex rows
        vals = np.sort(r.choice(max(40, 2 * C), size=n, replace=False))
        sig_d[u, :min(n, C)] = vals[:C]
        mapped_d[u] = 0 < n <= C
    return [torch.from_numpy(a).to(dev)
            for a in (single, slot, sig_d, mapped_d)]


@pytest.mark.parametrize("C", [16, 5, 1, 64])
@pytest.mark.parametrize("n_seg", [1, 2], ids=["single", "paired"])
@pytest.mark.parametrize("nu_share", [0.0, 0.4, 1.0], ids=["nu0", "some",
                                                          "all"])
def test_merge_kernel(dev, n_seg, C, nu_share):
    """K6 against the plain merge: overlapping lists, more than C distinct
    values (over), complex units (forced unmapped), empty units, no unit
    and every segment a unit; at C = 64 a block's rows need more than 48
    KB of shared memory; B not a multiple of the block."""
    args = _merge_inputs(dev, 20001, n_seg, C, nu_share, seed=C + n_seg)
    before = fast_cuda.merge_staging.launches
    got = fast_cuda.merge_staging(*args, C)
    want = probe.merge_staging(*args, C)
    torch.cuda.synchronize()
    assert fast_cuda.merge_staging.launches == before + 1
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("stride", [2, 16])
@pytest.mark.parametrize("n_seg", [1, 2], ids=["single", "paired"])
def test_fast_signatures_on_card(dev, world, stride, n_seg):
    """fast_cuda.two_phase_signatures (K5, K1, K2, K3, K6) against the
    plain route on the same card tensors, bit for bit, rows of unmapped
    reads included; the same bits on a rerun, whatever order K5's warps
    took their slots in. At C = 2 some re-probed segment has more than C
    distinct ECs and forces its read unmapped."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    L = 128
    mates = _fast_mates(dev, rng, seqs, 8192, L, n_seg)
    for C in (16, 2):
        counts = [f.launches for f in (fast_cuda.sample_classify,
                                       pack_cuda.pack_canonical_2bit,
                                       probe_cuda.lookup_ecs_aux,
                                       sig_cuda.read_signatures,
                                       fast_cuda.merge_staging)]
        got = fast_cuda.two_phase_signatures(mates, L, index.k, stride, C,
                                             *geo)
        assert [f.launches for f in (fast_cuda.sample_classify,
                                     pack_cuda.pack_canonical_2bit,
                                     probe_cuda.lookup_ecs_aux,
                                     sig_cuda.read_signatures,
                                     fast_cuda.merge_staging)] == [
            c + 1 for c in counts]
        want = probe.two_phase_signatures(mates, L, index.k, stride, C, *geo)
        again = fast_cuda.two_phase_signatures(mates, L, index.k, stride, C,
                                               *geo)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, again):
            _eq(a, b)
            _eq(c, b)
        assert bool(got[1].any()) and not bool(got[1].all())
        if C == 2:
            _, slot, units = probe.sample_classify(mates, L, index.k, stride,
                                                   *geo)
            hi, lo, valid = pack_cuda.plain(*units, L, index.k)
            sig_d, mapped_d = sig_cuda.plain(
                probe.lookup_ecs(hi, lo, valid, *geo), valid, C)
            assert bool(((sig_d[:, 0] != SIG_PAD) & ~mapped_d).any())


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_fast_map_step_on_card_matches_plain_route(dev, world, paired):
    """The whole fast map_step on the card (K5, K1, K2, K3, K6, A1) against
    the plain route (every step's plain version) on the same card tensors:
    equal merged tables; and the Mapper on the card against the Mapper on
    the CPU."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    L, B = 128, 4096
    mates = _fast_mates(dev, rng, seqs, B, L, 2 if paired else 1)
    w = torch.ones(B, dtype=torch.int32, device=dev)
    cfg = MapConfig(batch_size=B, sig_table_bits=14, paired_end=paired,
                    probe_sample=16)
    tables = [make_sig_table(14, 16, num_ecs=index.num_ecs, device=dev)
              for _ in range(2)]
    kw = dict(codes2=mates[1][0], lengths2=mates[1][2],
              bad2=mates[1][1]) if paired else {}
    before = fast_cuda.merge_staging.launches
    map_step(di, cfg, tables[0], mates[0][0], mates[0][2], w,
             bad=mates[0][1], pad_len=L, audit=True, **kw)
    assert fast_cuda.merge_staging.launches == before + 1
    sig, mapped = probe.two_phase_signatures(
        mates, L, index.k, 16, 16, di.table, di.main_slots, di.stash,
        di.stash_slots, di.bucket)
    accumulate_cuda.plain(tables[1], sig, mapped, weights=w, audit=True)
    torch.cuda.synchronize()
    _same_tables(tables)

    c1, c2, _ = simulate_packed_pairs(rng, seqs, 2, 1024, read_len=100,
                                      error_rate=0.01)
    ln = np.full(1024, 100, np.int32)
    batches = [ReadBatch(c1[i], ln, np.ones(1024, np.int32),
                         codes2=c2[i] if paired else None,
                         lengths2=ln if paired else None) for i in range(2)]
    cfg = MapConfig(batch_size=1024, sig_table_bits=14, paired_end=paired,
                    probe_sample=8)
    got = Mapper(index, cfg, device=dev).run(batches)
    want = Mapper(index, cfg, device="cpu").run(batches)
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.mapped, got.overflow, got.collisions) == (
        want.mapped, want.overflow, want.collisions)


def test_fast_wrappers_never_fall_back(dev, world):
    """What K5 and K6 do not take raises on the card; nothing moves to the
    plain version or the CPU."""
    rng, seqs, idx = world
    index = idx["default"]
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    mates = _fast_mates(dev, rng, seqs, 64, 128, 1)
    before = (fast_cuda.sample_classify.launches,
              fast_cuda.merge_staging.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fast_cuda.sample_classify([(mates[0][0], mates[0][1].cpu(),
                                    mates[0][2])], 128, index.k, 4, *geo)
    with pytest.raises(ValueError, match="fit"):
        fast_cuda.sample_classify(mates, 120, index.k, 4, *geo)
    args = _merge_inputs(dev, 100, 2, 16, 0.4, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        fast_cuda.merge_staging(args[0], args[1].t().contiguous().t(),
                                *args[2:], 16)
    with pytest.raises(ValueError, match="fit"):
        fast_cuda.merge_staging(*args, 8)
    assert (fast_cuda.sample_classify.launches,
            fast_cuda.merge_staging.launches) == before
