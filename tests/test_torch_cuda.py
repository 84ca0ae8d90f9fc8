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
from seekmer_tpu_torch.native.cpu_baseline import CpuBaselineMapper
from seekmer_tpu_torch.ops import (
    _build,
    accumulate_cuda,
    em_csr_cuda,
    em_cuda,
    em_dense,
    fast_cuda,
    pack_cuda,
    probe,
    probe_cuda,
    route,
    route_cuda,
    sig_cuda,
    strided_cuda,
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


def test_mapper_on_card_matches_cpu_baseline(dev, world):
    """The port's dense Mapper on the card (K1-K3, A1) and the compiled
    single-core CPU baseline on the same reads: equal raw mapped and
    distinct-signature counts, as ``chip_smoke.py``'s ``[baseline c2]``
    holds them at config 2."""
    rng, seqs, idx = world
    index = idx["stash"]
    B, L = 1024, 100
    c1, _ = simulate_packed_batches(rng, seqs, 3, B, read_len=L)
    ln = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    cfg = MapConfig(batch_size=B, sig_table_bits=14)
    got = Mapper(index, cfg, device=dev).run(
        [ReadBatch(c1[i], ln, w) for i in range(3)])
    with CpuBaselineMapper(index, sig_bits=14) as base:
        mapped = base.map(c1.reshape(-1, L), cfg.max_ecs_per_read)
        assert (mapped, base.distinct_signatures) == (got.mapped,
                                                      got.sigs.shape[0])
    assert got.overflow == 0 and got.mapped > 0


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
@pytest.mark.parametrize("stride", [2, 16, 8, 3])
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


@pytest.fixture(scope="module")
def wide_index():
    """An index at k = 29, the widest key the kernels take."""
    rng = np.random.default_rng(29)
    names, seqs = random_transcriptome(rng, num_transcripts=100, min_len=300,
                                       max_len=1500, shared_prefix_frac=0.5)
    return seqs, build_index_from_seqs(names, seqs, cfg=IndexConfig(k=29))


def _edge_mates(dev, rng, seqs, B, L, n_seg, read_len, view):
    """Mates of reads up to ``read_len`` bp (ragged, 2% errors, junk, N
    bases) padded to L, with all-invalid mates (every base N) every 13
    reads and pad rows (length 0) every 29; with ``view`` each tensor is a
    view that starts one row into a larger one, so its rows do not start
    on a 16-byte boundary."""
    mates = []
    for g in range(n_seg):
        codes, _ = simulate_packed_batches(rng, seqs, 1, B, read_len=read_len,
                                           error_rate=0.02)
        padded = np.full((B, L), 4, np.uint8)
        padded[:, :read_len] = codes[0]
        dead = rng.random(B) < 0.2
        padded[dead, :read_len] = rng.integers(0, 4, size=(int(dead.sum()),
                                                           read_len))
        padded[rng.random((B, L)) < 0.005] = 4
        lengths = rng.integers(0, read_len + 1, size=B).astype(np.int32)
        lengths[rng.random(B) < 0.5] = read_len
        padded[g::13] = 4
        lengths[g::29] = 0
        packed, bad = enc.pack_codes_2bit(padded)
        arrays = (packed, bad, lengths)
        if view:
            arrays = tuple(np.concatenate([a[-1:], a]) for a in arrays)
        t = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        mates.append(tuple(x[1:] for x in t) if view else t)
    return mates


@pytest.mark.parametrize("case", [
    # L, k, stride, n_seg, B, read length, views
    (256, 29, 2, 2, 1001, 250, False),   # 115 columns a segment, a read a warp
    (256, 29, 3, 1, 999, 200, True),     # S > 32 single-end, unaligned rows
    (128, 29, 8, 2, 4099, 100, False),   # 9 pairs a warp, 4099 % 9 = 4
    (100, 29, 16, 2, 777, 100, True),    # rows of 25 and 13 bytes
    (37, 29, 4, 1, 501, 37, False),      # 3 sampled columns, 32 reads a warp
    (29, 29, 2, 2, 300, 29, True),       # one window a segment
], ids=["L256-s2", "L256-s3-single", "L128-s8", "L100-s16", "L37-s4",
        "L29-s2"])
def test_sample_kernel_edges(dev, wide_index, case):
    """K5 against the plain sample_classify at k = 29 on the plan's edges:
    s = 2 at L 256 (more than 32 sampled columns a segment), B not a
    multiple of the reads a warp takes, rows whose widths are not
    multiples of 4 or 8 bytes (the units' copies in narrower vectors),
    all-invalid mates and pad rows, and tensors whose rows start off a
    16-byte boundary; then the whole fast route against the plain one."""
    L, k, stride, n_seg, B, read_len, view = case
    seqs, index = wide_index
    assert index.k == k
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    rng = np.random.default_rng(L + stride)
    mates = _edge_mates(dev, rng, seqs, B, L, n_seg, read_len, view)
    got, _ = _check_sample(mates, L, k, stride, geo)
    assert 0 < got[2][0].shape[0] < B * n_seg
    sig, mapped = fast_cuda.two_phase_signatures(mates, L, k, stride, 16,
                                                 *geo)
    want = probe.two_phase_signatures(mates, L, k, stride, 16, *geo)
    _eq(sig, want[0])
    _eq(mapped, want[1])


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


@pytest.mark.parametrize("C", [16, 5, 1, 64, 32, 33, 2, 17])
@pytest.mark.parametrize("n_seg", [1, 2], ids=["single", "paired"])
@pytest.mark.parametrize("nu_share", [0.0, 0.4, 1.0], ids=["nu0", "some",
                                                          "all"])
def test_merge_kernel(dev, n_seg, C, nu_share):
    """K6 against the plain merge: overlapping lists, more than C distinct
    values (over), complex units (forced unmapped), empty units, no unit
    and every segment a unit; C 1, 2, 5, 16, 17, 32, 33 and 64 (at C = 64
    a block's rows need more than 48 KB of shared memory); B not a
    multiple of the block."""
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


# ---- A3: the CSR EM iteration ------------------------------------------------


def _csr_system(T, E, B, dtype, seed):
    """A random EC table on the CPU (1-6 members an EC in no sorted order,
    two empty ECs, the last 3 transcripts in no EC) as its layout, with
    counts (E, B) that have zero rows, eff, and a start iterate (T, B) with
    zero rows, so that some ECs have d = 0."""
    from seekmer_tpu_torch.em.em import build_ec_table, csr_layout

    rng = np.random.default_rng(seed)
    members = [rng.choice(T - 3, size=int(rng.integers(1, 7)),
                          replace=False).astype(np.int32) for _ in range(E)]
    members[1] = members[1][:0]
    members[-1] = members[-1][:0]
    ec = build_ec_table(members, np.ones(E), T, device="cpu")
    n = rng.integers(0, 300, size=(E, B)).astype(np.float64)
    n[::5] = 0
    eff = np.maximum(rng.integers(250, 3000, size=T) - 180.0, 1.0)
    alpha = rng.random((T, B)) * 50
    alpha[::6] = 0
    return (csr_layout(ec.ec_ids, ec.txp_ids, E, T),
            *(torch.from_numpy(a).to(dtype) for a in (n, eff, alpha)))


def _on(dev, layout):
    from seekmer_tpu_torch.em.em import csr_layout

    return csr_layout(layout.ec_ids.to(dev), layout.txp_ids.to(dev),
                      layout.num_ecs, layout.num_transcripts)


def _csr_args(dev, layout, n, eff, alpha, divide):
    """(alpha, counts, scale) of the single run (``divide``: column 0,
    eff) or of the batched form (1 / eff), on ``dev``."""
    if divide:
        args = (alpha[:, 0].contiguous(), n[:, 0].contiguous(), eff)
    else:
        args = (alpha, n, 1.0 / eff)
    return tuple(a.to(dev) for a in args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 3, 32, 100, 129])
def test_em_csr_kernel_equals_cpu_bits(dev, B, dtype):
    """A3 against its plain version on the CPU, on the same inputs: the
    last two of 5 iterates bit for bit, batched at every B and (at B = 1)
    the single run; transcripts in no EC get 0."""
    layout, n, eff, alpha = _csr_system(70, 160, B, dtype, seed=B)
    lay = _on(dev, layout)
    for divide in ([False, True] if B == 1 else [False]):
        before = em_csr_cuda.em_steps.launches
        got = em_csr_cuda.em_steps(*_csr_args(dev, layout, n, eff, alpha,
                                              divide), lay, 5, divide)
        torch.cuda.synchronize()
        assert em_csr_cuda.em_steps.launches == before + 1
        want = em_csr_cuda.em_steps(*_csr_args("cpu", layout, n, eff, alpha,
                                               divide), layout, 5, divide)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == dtype
            _eq(g.cpu(), w)
        assert bool((got[1][-3:] == 0).all())
        assert float(got[1].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("divide", [False, True], ids=["batched", "single"])
def test_em_csr_kernel_in_squarem(dev, divide, dtype):
    """SQUAREM cycles on the card, A3 one step a call: every call's output
    equals the plain version's on the CPU from the same (extrapolated)
    input."""
    from seekmer_tpu_torch.em.em import squarem_cycle

    layout, n, eff, alpha = _csr_system(70, 160, 4, dtype, seed=11)
    lay = _on(dev, layout)
    a, counts, scale = _csr_args(dev, layout, n, eff, alpha, divide)
    cpu = _csr_args("cpu", layout, n, eff, alpha, divide)
    seen = []

    def em_iter(x):
        out = em_csr_cuda.em_steps(x, counts, scale, lay, 1, divide)[1]
        seen.append((x.cpu(), out.cpu()))
        return out

    for _ in range(4):
        a = squarem_cycle(em_iter, a)
    assert len(seen) == 12
    for x, out in seen:
        _eq(out, em_csr_cuda.em_steps(x, *cpu[1:], layout, 1, divide)[1])
    assert bool(torch.isfinite(a).all()) and bool((a >= 0).all())


def test_em_csr_kernel_zero_mass_and_rerun(dev):
    """An all-zero iterate (every d = 0) gives zeros; 16 steps at B = 100
    give the same bits twice."""
    layout, n, eff, alpha = _csr_system(300, 700, 100, torch.float32,
                                        seed=5)
    lay = _on(dev, layout)
    a, counts, scale = _csr_args(dev, layout, n, eff, alpha, False)
    zero = em_csr_cuda.em_steps(torch.zeros_like(a), counts, scale, lay, 3,
                                False)[1]
    assert bool((zero == 0).all())
    one = em_csr_cuda.em_steps(a, counts, scale, lay, 16, False)
    two = em_csr_cuda.em_steps(a, counts, scale, lay, 16, False)
    for x, y in zip(one, two):
        _eq(x, y)


def test_em_and_bootstrap_on_card_equal_cpu_bits(dev):
    """The entry points: run_em (float32 and float64) and batched_em on a
    CUDA table give the CPU's iteration counts and bits (sd = 0: the
    effective lengths are exact on both; replicates of unequal totals, so
    the start values N_b / T are divided on the card)."""
    import dataclasses

    from seekmer_tpu_torch.em.bootstrap import batched_em
    from seekmer_tpu_torch.em.em import build_ec_table, run_em

    rng = np.random.default_rng(8)
    T, E = 117, 300
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 6)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(0, 400, size=E).astype(np.float64)
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    cfg = EMConfig(rel_tol=1e-6, max_iters=3000)
    for x64 in (False, True):
        dt = torch.float64 if x64 else torch.float32
        c = dataclasses.replace(cfg, use_x64=x64)
        before = em_csr_cuda.em_steps.launches
        got = run_em(build_ec_table(members, counts, T, dtype=dt, device=dev),
                     lengths, c)
        assert em_csr_cuda.em_steps.launches - before == 1
        want = run_em(build_ec_table(members, counts, T, dtype=dt,
                                     device="cpu"), lengths, c)
        assert got[1] == want[1]
        _eq(got[0].cpu(), want[0])
    N = int(counts.sum())
    cmat = torch.from_numpy(np.stack([rng.multinomial(N - 37 * b, counts / N)
                                      for b in range(4)]).astype(np.float32))
    ec = build_ec_table(members, counts, T, device="cpu")
    want = batched_em(cmat, ec.ec_ids, ec.txp_ids, lengths, E, T, cfg)
    before = em_csr_cuda.em_steps.launches
    got = batched_em(cmat.to(dev), ec.ec_ids.to(dev), ec.txp_ids.to(dev),
                     lengths, E, T, cfg)
    assert got[1] == want[1] and got[1] > 16
    assert em_csr_cuda.em_steps.launches - before == 1  # one fixed point
    _eq(got[0].cpu(), want[0])


def test_em_csr_kernel_never_falls_back(dev, monkeypatch):
    """What A3 does not take raises on the card, and so do a failed build
    and a failed launch; nothing moves to the plain version or the CPU."""
    layout, n, eff, alpha = _csr_system(70, 160, 3, torch.float32, seed=2)
    lay = _on(dev, layout)
    a, counts, scale = _csr_args(dev, layout, n, eff, alpha, False)
    before = em_csr_cuda.em_steps.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        em_csr_cuda.em_steps(a.half(), counts.half(), scale.half(), lay, 2,
                             False)
    with pytest.raises(ValueError, match="float32 or float64"):
        em_csr_cuda.em_steps(a, counts.double(), scale, lay, 2, False)
    with pytest.raises(ValueError, match="contiguous"):
        em_csr_cuda.em_steps(a, counts.t().contiguous().t(), scale, lay, 2,
                             False)
    with pytest.raises(ValueError, match="CUDA"):
        em_csr_cuda.em_steps(a, counts, scale, layout, 2, False)
    with pytest.raises(ValueError, match="shapes"):
        em_csr_cuda.em_steps(a[:-1].contiguous(), counts, scale, lay, 2,
                             False)
    with pytest.raises(ValueError, match="divide"):
        em_csr_cuda.em_steps(a, counts, scale, lay, 2, True)

    def failed_build(*args):
        raise RuntimeError("nvcc failed: (test)")

    monkeypatch.setattr(_build, "function", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        em_csr_cuda.em_steps(a, counts, scale, lay, 2, False)
    monkeypatch.setattr(_build, "function", lambda *args: lambda *x: 700)
    with pytest.raises(RuntimeError, match="em_csr failed: cudaError 700"):
        em_csr_cuda.em_steps(a, counts, scale, lay, 2, False)
    assert em_csr_cuda.em_steps.launches == before


def test_infer_on_card_launches_a3_on_both_csr_routes(dev, world, tmp_path):
    """``infer --device cuda``: single-run EM takes A3 in one launch for
    the whole fixed point; an x64 bootstrap takes the batched CSR route
    through one more A3 launch, a float32 one on this small system the
    dense route (K4 once). The x64 point estimate equals the CPU run's
    bits."""
    import json

    from seekmer_tpu_torch import cli
    from seekmer_tpu_torch.io.writer import read_abundance
    from seekmer_tpu_torch.utils.simulate import (simulate_reads,
                                                  write_fasta, write_fastq)

    _, seqs, _ = world
    fa, fq, idx = (str(tmp_path / f) for f in ("ref.fa", "r.fq", "i.npz"))
    write_fasta(fa, [f"t{i}" for i in range(len(seqs))], seqs)
    sim = simulate_reads(np.random.default_rng(9), seqs, num_reads=3000,
                         read_len=100, error_rate=0.005)
    write_fastq(fq, sim.reads1)
    assert cli.main(["index", fa, idx]) == 0
    runs = {}
    for name, device, extra in (("x64", "cuda", ["--x64"]),
                                ("x64_cpu", "cpu", ["--x64"]),
                                ("f32", "cuda", [])):
        out = tmp_path / name
        before = cli.kernel_launches()
        assert cli.main(["infer", idx, str(out), fq, "--device", device,
                         "--batch-size", "1024", "--bootstrap", "8",
                         "--seed", "3", *extra]) == 0
        info = json.loads((out / "run_info.json").read_text())
        after = info["kernel_launches"]
        runs[name] = (info, {k: after[k] - before[k] for k in after},
                      read_abundance(str(out / "abundance.tsv")))
    info, d, _ = runs["x64"]
    single = info["em_iterations"] // 16
    boot = int(info["timings"]["bootstrap_iterations"]) // 16
    assert single > 0 and boot > 0
    assert (d["em_csr"], d["em"], d["ec_sum"]) == (2, 0, 1)
    assert runs["x64_cpu"][1]["em_csr"] == runs["x64_cpu"][1]["ec_sum"] == 0
    assert info["log_likelihood"] == runs["x64_cpu"][0]["log_likelihood"]
    assert info["em_iterations"] == runs["x64_cpu"][0]["em_iterations"]
    np.testing.assert_array_equal(runs["x64"][2]["est_counts"],
                                  runs["x64_cpu"][2]["est_counts"])
    info, d, _ = runs["f32"]
    assert (d["em_csr"], d["em"]) == (1, 1)


# ---- A3: the whole fixed point in one launch ---------------------------------


def _gene_system(genes, chain, B, dtype, seed):
    """A transcriptome-shaped EC table on the CPU: genes of 1-4 isoforms
    with ECs over subsets of a gene (members in no sorted order), a gene
    family of ``chain`` transcripts linked EC by EC (0: none), two
    transcripts in no EC, two empty ECs, the ECs shuffled; as its layout,
    with counts (E, B) that have zero rows, eff, and the even start
    iterate (T, B) of ``batched_em``."""
    from seekmer_tpu_torch.em.em import build_ec_table, csr_layout

    rng = np.random.default_rng(seed)
    members, T = [], 0
    for _ in range(genes):
        k = int(rng.integers(1, 5))
        for _ in range(int(rng.integers(1, 2 * k + 1))):
            members.append(T + rng.choice(k, size=int(rng.integers(1, k + 1)),
                                          replace=False))
        T += k
    members += [np.array([T + j + 1, T + j]) for j in range(chain - 1)]
    T += chain + 2
    members += [np.zeros(0, np.int64)] * 2
    members = [members[k].astype(np.int32)
               for k in rng.permutation(len(members))]
    E = len(members)
    ec = build_ec_table(members, np.ones(E), T, device="cpu")
    n = rng.integers(0, 300, size=(E, B)).astype(np.float64)
    n[::5] = 0
    eff = np.maximum(rng.integers(250, 3000, size=T) - 180.0, 1.0)
    alpha = np.repeat(n.sum(axis=0, keepdims=True) / T, T, axis=0)
    return (csr_layout(ec.ec_ids, ec.txp_ids, E, T),
            *(torch.from_numpy(a).to(dtype) for a in (n, eff, alpha)))


def _fixed_both(dev, layout, n, eff, alpha, divide, cfg, it_init=0):
    """em_fixed_point on the card (one launch, checked) and on the CPU."""
    lay = _on(dev, layout)
    before = em_csr_cuda.em_steps.launches
    got = em_csr_cuda.em_fixed_point(
        *_csr_args(dev, layout, n, eff, alpha, divide), lay, cfg, divide,
        it_init=it_init)
    assert em_csr_cuda.em_steps.launches == before + 1
    want = em_csr_cuda.em_fixed_point(
        *_csr_args("cpu", layout, n, eff, alpha, divide), layout, cfg,
        divide, it_init=it_init)
    assert got[0].device.type == "cuda"
    _eq(got[0].cpu(), want[0])
    assert got[1:] == want[1:]
    return got, lay


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 3, 32, 100, 129])
def test_em_csr_fixed_point_equals_cpu(dev, B, dtype):
    """The whole fixed point in one launch against the plain blocked loop
    on the CPU: equal bits, iteration count and converged flag, where it
    converges (27-49 blocks) and where it stops at max_iters (not a
    multiple of check_every), batched at every B and (at B = 1) the single
    run."""
    layout, n, eff, alpha = _gene_system(60, 0, B, dtype, seed=B)
    for divide in ([False, True] if B == 1 else [False]):
        got, lay = _fixed_both(dev, layout, n, eff, alpha, divide,
                               EMConfig(rel_tol=3e-2, max_iters=2000))
        assert got[2] and 16 < got[1] < 2000
        tl = em_csr_cuda.tiling(lay, B, dtype)
        assert tl.ntiles > 1 and tl.global_rows == (0, 0)
        got, _ = _fixed_both(dev, layout, n, eff, alpha, divide,
                             EMConfig(rel_tol=0.0, max_iters=100,
                                      check_every=7))
        assert got[1:] == (105, False)


@pytest.mark.parametrize("genes", [0, 40], ids=["alone", "beside_small"])
@pytest.mark.parametrize("B", [1, 100])
def test_em_csr_fixed_point_global_route(dev, B, genes):
    """A component too large for a tile (a gene family of 4,000
    transcripts) takes the global route inside the same launch, alone and
    beside small components in tiles: the CPU's bits, count and flag."""
    layout, n, eff, alpha = _gene_system(genes, 4000, B, torch.float32,
                                         seed=7 + genes)
    for divide in ([False, True] if B == 1 else [False]):
        got, lay = _fixed_both(dev, layout, n, eff, alpha, divide,
                               EMConfig(rel_tol=1e-4, max_iters=160))
        tl = em_csr_cuda.tiling(lay, B, torch.float32)
        assert tl.global_rows == (4000, 3999) and tl.largest == (4000, 3999)
        # the two transcripts in no EC and the two empty ECs are tiles
        assert tl.ntiles >= 1 + (genes > 0)


def test_em_csr_fixed_point_streamed(dev):
    """More (tile, slice) items than the grid holds at once: every block
    streams its items through shared memory each block of steps."""
    layout, n, eff, alpha = _gene_system(9000, 0, 129, torch.float32,
                                         seed=3)
    got, lay = _fixed_both(dev, layout, n, eff, alpha, False,
                           EMConfig(rel_tol=1e-3, max_iters=64))
    tl = em_csr_cuda.tiling(lay, 129, torch.float32)
    assert not tl.resident and tl.slices == 5 and tl.width == 26


def test_em_csr_fixed_point_zero_mass_resume_and_rerun(dev):
    """A zero start (no active transcript: never converges, runs to
    max_iters), a resumed run (``it_init`` > 0, counting from it), a run
    whose it_init is already max_iters (no launch), and a rerun giving the
    same bits."""
    layout, n, eff, alpha = _gene_system(60, 30, 100, torch.float32,
                                         seed=4)
    cfg = EMConfig(rel_tol=1e-3, max_iters=200)
    got, lay = _fixed_both(dev, layout, n, eff, torch.zeros_like(alpha),
                           False, cfg)
    assert got[1:] == (208, False) and bool((got[0] == 0).all())
    got, _ = _fixed_both(dev, layout, n, eff, alpha, False, cfg, it_init=48)
    assert got[1] > 48 and (got[1] - 48) % 16 == 0
    args = _csr_args(dev, layout, n, eff, alpha, False)
    before = em_csr_cuda.em_steps.launches
    same = em_csr_cuda.em_fixed_point(*args, lay, cfg, False, it_init=200)
    assert same[0] is args[0] and same[1:] == (200, False)
    assert em_csr_cuda.em_steps.launches == before
    one = em_csr_cuda.em_fixed_point(*args, lay, cfg, False)
    two = em_csr_cuda.em_fixed_point(*args, lay, cfg, False)
    _eq(one[0], two[0])
    assert one[1:] == two[1:]


def test_em_csr_fixed_point_never_falls_back(dev, monkeypatch):
    """What the fixed point does not take raises on the card, and so do a
    failed build and a failed launch; nothing moves to the CPU."""
    layout, n, eff, alpha = _gene_system(20, 0, 3, torch.float32, seed=2)
    lay = _on(dev, layout)
    a, counts, scale = _csr_args(dev, layout, n, eff, alpha, False)
    cfg = EMConfig()
    before = em_csr_cuda.em_steps.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        em_csr_cuda.em_fixed_point(a, counts.double(), scale, lay, cfg,
                                   False)
    with pytest.raises(ValueError, match="CUDA"):
        em_csr_cuda.em_fixed_point(a, counts, scale, layout, cfg, False)
    with pytest.raises(ValueError, match="divide"):
        em_csr_cuda.em_fixed_point(a, counts, scale, lay, cfg, True)

    def failed_build(*args):
        raise RuntimeError("nvcc failed: (test)")

    monkeypatch.setattr(_build, "function", failed_build)
    em_csr_cuda.grid_shape.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        em_csr_cuda.em_fixed_point(a, counts, scale, lay, cfg, False)
    monkeypatch.setattr(_build, "function", lambda *args: lambda *x: 700)
    with pytest.raises(RuntimeError, match="em_csr failed: cudaError 700"):
        em_csr_cuda.em_fixed_point(a, counts, scale, lay, cfg, False)
    monkeypatch.undo()
    em_csr_cuda.grid_shape.cache_clear()
    assert em_csr_cuda.em_steps.launches == before


@pytest.mark.parametrize("B", [1, 100])
def test_em_csr_kernel_wide_range_values(dev, B):
    """Iterates, counts and lengths across the float32 range (subnormal
    iterates and weights, zeros, up to 1e20) so that every quotient meets
    operands from subnormal to large: the CPU's bits over 3 steps, single
    run and batched, finite throughout."""
    layout, n, eff, alpha = _gene_system(300, 40, B, torch.float32, seed=21)
    rng = np.random.default_rng(22)
    exp = rng.uniform(-44, 20, size=tuple(alpha.shape))
    alpha = torch.from_numpy((10.0 ** exp).astype(np.float32))
    alpha[rng.random(tuple(alpha.shape)) < 0.1] = 0
    n = torch.from_numpy((10.0 ** rng.uniform(-40, 10, size=tuple(n.shape)))
                         .astype(np.float32)) * (n > 0)
    eff = torch.from_numpy((10.0 ** rng.uniform(-5, 5, size=tuple(
        eff.shape))).astype(np.float32))
    lay = _on(dev, layout)
    for divide in ([False, True] if B == 1 else [False]):
        got = em_csr_cuda.em_steps(*_csr_args(dev, layout, n, eff, alpha,
                                              divide), lay, 3, divide)
        want = em_csr_cuda.em_steps(*_csr_args("cpu", layout, n, eff, alpha,
                                               divide), layout, 3, divide)
        for g, w in zip(got, want):
            _eq(g.cpu(), w)
        assert bool(torch.isfinite(got[1]).all())


# ---- strided mode (K7) and fusion mode (K3 segments, A1 at width 2C) ------


def _strided_lanes(dev, index, seqs, rng, B, read_len, error_rate, paired):
    """(hi, lo, valid) [B, W] of simulated reads with errors through K1,
    W = P or 2P (a pair's mates side by side), with an all-invalid row, an
    N run and a pad row of length 0."""
    from seekmer_tpu_torch.utils.simulate import simulate_reads

    L = read_len
    P = L - index.k + 1
    parts = []
    for _ in range(2 if paired else 1):
        sim = simulate_reads(rng, seqs, num_reads=B, read_len=L,
                             error_rate=error_rate)
        codes = np.full((B, L), 4, np.uint8)
        lengths = np.full(B, L, np.int32)
        for i, r in enumerate(sim.reads1):
            c = enc.seq_to_codes(r)
            codes[i, :c.size] = c
            lengths[i] = c.size
        codes[3] = 4  # an all-N read
        codes[5, 20:45] = 4  # a run of N bases
        lengths[7] = 0  # a pad row
        packed, bad = (torch.from_numpy(a).to(dev)
                       for a in enc.pack_codes_2bit(codes))
        parts.append(pack_cuda.pack_canonical_2bit(
            packed, bad, torch.from_numpy(lengths).to(dev), L, index.k))
    lanes = tuple(torch.cat([p[i] for p in parts], dim=1).contiguous()
                  for i in range(3))
    assert lanes[0].shape == (B, P * len(parts))
    return lanes


@pytest.fixture(scope="module")
def k29_world(world):
    _, seqs, _ = world
    return build_index_from_seqs([f"t{i}" for i in range(len(seqs))], seqs,
                                 cfg=IndexConfig(k=29))


@pytest.mark.parametrize("which", ["default", "stash", "k29"])
@pytest.mark.parametrize("stride", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("read_len", [100, 97], ids=["P_even", "P_odd"])
def test_strided_kernel(dev, world, k29_world, which, stride, paired,
                        read_len):
    """K7 against its plain version, bit for bit: single-end and a pair's
    mates as two segments of one row, P even and odd at k = 25 (76 / 73
    windows; 72 / 69 at k = 29), stash hits (the bucket-4 index), errors,
    all-invalid and pad rows; one launch a call."""
    rng, seqs, idx = world
    index = k29_world if which == "k29" else idx[which]
    di = DeviceIndex.from_host(index, dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    hi, lo, valid = _strided_lanes(dev, index, seqs, rng, 3001, read_len,
                                   0.01, paired)
    segs = 2 if paired else 1
    before = strided_cuda.lookup_ecs_strided.launches
    got = strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, stride,
                                          segments=segs)
    torch.cuda.synchronize()
    assert strided_cuda.lookup_ecs_strided.launches == before + 1
    want = strided_cuda.plain(hi, lo, valid, *geo, stride, segs)
    _eq(got, want)
    dense = probe_cuda.lookup_ecs(hi, lo, valid, *geo)
    hit = valid & (dense >= 0)
    assert torch.equal(got[hit], dense[hit])
    assert bool((got[~valid] == -1).all())


def test_strided_kernel_every_window_needy(dev, world):
    """A table with no run lengths (aux 0): no sample covers a gap, so every
    valid non-sampled window goes through the needy rounds, and the result
    equals dense mode."""
    rng, seqs, idx = world
    index = idx["default"]
    table = index.table.copy()
    table[:, 3] = 0
    stash = index.stash.copy()
    stash[:, 3] = 0
    dt = torch.from_numpy(probe.device_table_layout(table, index.bucket))
    ds = torch.from_numpy(probe.device_table_layout(stash, index.bucket))
    geo = (dt.to(dev), index.main_slots, ds.to(dev), index.stash_slots,
           index.bucket)
    hi, lo, valid = _strided_lanes(dev, index, seqs, rng, 2000, 100, 0.0,
                                   True)
    got = strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, 4,
                                          segments=2)
    _eq(got, strided_cuda.plain(hi, lo, valid, *geo, 4, 2))
    _eq(got, probe_cuda.lookup_ecs(hi, lo, valid, *geo))


def test_strided_wrapper_never_falls_back(dev, world, monkeypatch):
    """A CUDA tensor goes through K7 or raises: a failing launch raises,
    and the plain version is never called."""
    rng, seqs, idx = world
    di = DeviceIndex.from_host(idx["default"], dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    hi, lo, valid = _strided_lanes(dev, idx["default"], seqs, rng, 64, 100,
                                   0.0, False)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(strided_cuda, "_plain", no_plain)
    monkeypatch.setattr(strided_cuda, "plain", no_plain)
    strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, 4)
    with pytest.raises(ValueError, match="strides of 2"):
        strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, 1)
    with pytest.raises(ValueError, match="equal segments"):
        strided_cuda.lookup_ecs_strided(hi[:, :75], lo[:, :75],
                                        valid[:, :75], *geo, 4, segments=2)
    # a plan the kernel's launcher refuses (a carve with no room for the
    # slots): the launch fails and raises
    real = strided_cuda.strided_plan
    monkeypatch.setattr(strided_cuda, "strided_plan",
                        lambda *a: real(*a)._replace(queue_at=0))
    with pytest.raises(RuntimeError, match="strided_lookup failed"):
        strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, 4)


def _card_plan(dev, P, stride, n_seg):
    return strided_cuda.strided_plan(P, stride, n_seg,
                                     torch.cuda.get_device_properties(
                                         dev).multi_processor_count)


@pytest.mark.parametrize("case", ["short_last_tile", "unaligned_P75",
                                  "valid_off_16B"])
@pytest.mark.parametrize("stride", [2, 4, 16])
def test_strided_kernel_tiles_and_starts(dev, world, case, stride):
    """K7 against its plain version, bit for bit, where its tiles and
    staging meet their edges: a batch of more segments than the card holds
    warps whose last tile is shorter than the rest (so every warp walks
    several tiles and carries needy keys across them); a ``[:, 1:]`` slice
    made contiguous (P = 75: tiles start anywhere in a 16-byte chunk, the
    scalar fill); valid one byte past a 16-byte boundary (P = 76, the
    4-window fill)."""
    rng, seqs, idx = world
    di = DeviceIndex.from_host(idx["default"], dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    if case == "short_last_tile":
        B = 9001
        while True:  # pairs: 2 B segments, more than the card's warps
            plan = _card_plan(dev, 76, stride, 2 * B)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            if (2 * B) % plan.segs and -(-2 * B // plan.segs) > (
                    strided_cuda.resident_warps(sms, plan.blocks)):
                break
            B += 1
        hi, lo, valid = _strided_lanes(dev, idx["default"], seqs, rng, B,
                                       100, 0.01, True)
        segs = 2
    else:
        hi, lo, valid = _strided_lanes(dev, idx["default"], seqs, rng, 3001,
                                       100, 0.01, False)
        segs = 1
        if case == "unaligned_P75":
            hi, lo, valid = (x[:, 1:].contiguous() for x in (hi, lo, valid))
        else:
            flat = torch.zeros(valid.numel() + 17, dtype=torch.bool,
                               device=dev)
            off = (16 - flat.data_ptr() % 16) % 16 + 1
            valid = flat[off:off + valid.numel()].view(valid.shape).copy_(
                valid)
            assert valid.is_contiguous() and valid.data_ptr() % 16 == 1
    P = hi.shape[1] // segs
    before = dict(strided_cuda.lookup_ecs_strided.paths)
    got = strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, stride,
                                          segments=segs)
    torch.cuda.synchronize()
    path = "vec4" if P % 4 == 0 else "scalar"
    assert strided_cuda.lookup_ecs_strided.paths[path] == before[path] + 1
    _eq(got, strided_cuda.plain(hi, lo, valid, *geo, stride, segs))


def test_strided_kernel_both_fill_paths_ran(dev, world):
    """One batch of P = 76 windows (the 4-window fill, an int4 of ec a
    lane) and one of P = 73 (the scalar fill) each launch their path once,
    and each equals the plain version."""
    rng, seqs, idx = world
    di = DeviceIndex.from_host(idx["default"], dev)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    ran = {}
    for read_len in (100, 97):
        lanes = _strided_lanes(dev, idx["default"], seqs, rng, 2000,
                               read_len, 0.01, False)
        before = dict(strided_cuda.lookup_ecs_strided.paths)
        got = strided_cuda.lookup_ecs_strided(*lanes, *geo, 8)
        _eq(got, strided_cuda.plain(*lanes, *geo, 8))
        after = strided_cuda.lookup_ecs_strided.paths
        ran[read_len] = {k: after[k] - before[k] for k in after}
    assert ran == {100: {"vec4": 1, "scalar": 0},
                   97: {"vec4": 0, "scalar": 1}}


def _ll_table(E, T, big, seed):
    """A random EC table on the CPU: 1-3 members an EC (nnz ~ 2 E, as
    config 2's 83,019 ECs hold 168,900), one EC of ``big`` members, an
    empty EC, zero counts and zero alpha."""
    from seekmer_tpu_torch.em.em import build_ec_table

    rng = np.random.default_rng(seed)
    members = [np.sort(rng.choice(T, size=int(rng.choice([1, 2, 3],
                                                          p=[.4, .3, .3])),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    members[1] = members[1][:0]
    members[2] = np.sort(rng.choice(T, size=big, replace=False)).astype(
        np.int32)
    counts = rng.integers(0, 400, size=E).astype(np.float64)
    counts[::9] = 0
    alpha = rng.random(T) * 80
    alpha[::11] = 0
    eff = np.maximum(rng.integers(250, 3000, size=T) - 180.0, 1.0)
    return members, counts, alpha, eff


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("size", ["tiny", "config2"])
def test_log_likelihood_on_card_equals_cpu_bits(dev, dtype, size):
    """em.log_likelihood on CUDA tensors gives equal bits in two runs and
    the CPU's bits, on a tiny table and on one of config 2's size (83,019
    ECs, 57,273 transcripts, an EC of 300 members)."""
    from seekmer_tpu_torch.em.em import build_ec_table, log_likelihood

    E, T, big = (150, 60, 40) if size == "tiny" else (83019, 57273, 300)
    members, counts, alpha, eff = _ll_table(E, T, big, seed=E)
    got = {}
    for d in ("cpu", dev, dev):
        ec = build_ec_table(members, counts, T, dtype=dtype, device=d)
        a, e = (torch.from_numpy(x).to(dtype).to(d) for x in (alpha, eff))
        got.setdefault(str(d), []).append(log_likelihood(ec, a, e))
    cpu, card = got["cpu"][0], got[str(dev)]
    assert cpu.dtype == dtype and bool(torch.isfinite(cpu))
    assert card[0].item() == card[1].item() == cpu.item()


def _ec_sum_table(size, dtype):
    """(w, ec_ids, E) on the CPU for ``test_ec_sum_kernel``: ``_ll_table``'s
    tiny or config-2-sized table with three empty ECs appended, or 5,000
    ECs of 1-5 members with empty runs at the start, inside and at the
    end of the id range (``gaps``) or one EC of 1,234 members (``long``)."""
    from seekmer_tpu_torch.em.em import build_ec_table

    if size in ("tiny", "config2"):
        E, T, big = (150, 60, 40) if size == "tiny" else (83019, 57273, 300)
        members, counts, _, _ = _ll_table(E, T, big, seed=E + 1)
        ec = build_ec_table(members + [members[1]] * 3,
                            np.append(counts, [0] * 3), T, dtype=dtype,
                            device="cpu")
        ids, E = ec.ec_ids, ec.num_ecs
    else:
        rng = np.random.default_rng(len(size))
        sizes = rng.integers(1, 6, size=5000)
        if size == "gaps":
            sizes[[0, 1, 2, 999, 2000, 2001, 2002, 2003, 4997, 4998,
                   4999]] = 0
        else:
            sizes[777] = 1234
        ids, E = torch.from_numpy(np.repeat(np.arange(5000), sizes)), 5000
    w = torch.from_numpy(np.random.default_rng(E).random(
        ids.numel()) * 10).to(dtype)
    return w, ids, E


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("size", ["tiny", "config2", "gaps", "long"])
def test_ec_sum_kernel(dev, dtype, size, monkeypatch):
    """A4 (``em_csr_cuda.ec_sums``) on CUDA tensors: one launch a call, no
    plain version, and the bits of the plain version on the CPU and on the
    card, on a tiny table and on one of config 2's size (an EC of 300
    members), each with an empty EC and three empty ECs after the last
    member, and on tables with empty runs at the start, inside and at the
    end, and with an EC of 1,234 members; a table with no term is zeros
    and launches nothing, an empty table too."""
    w, ids, E = _ec_sum_table(size, dtype)
    want = em_csr_cuda.plain_ec_sums(w, ids, E)
    on_card = em_csr_cuda.plain_ec_sums(w.to(dev), ids.to(dev), E)
    assert torch.equal(on_card.cpu(), want)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(em_csr_cuda, "plain_ec_sums", no_plain)
    before = em_csr_cuda.ec_sums.launches
    got = em_csr_cuda.ec_sums(w.to(dev), ids.to(dev), E)
    assert em_csr_cuda.ec_sums.launches == before + 1
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    empty = torch.empty(0, dtype=dtype, device=dev)
    assert em_csr_cuda.ec_sums(
        empty, empty.to(torch.int64), 0).numel() == 0
    none = em_csr_cuda.ec_sums(empty, empty.to(torch.int64), 7)
    assert torch.equal(none.cpu(), torch.zeros(7, dtype=dtype))
    assert em_csr_cuda.ec_sums.launches == before + 1


@pytest.mark.parametrize("P,C", [(104, 16), (101, 16), (76, 8), (488, 16),
                                 (3, 4)])
def test_signature_kernel_segments(dev, world, P, C):
    """K3 with segments=2 against its plain version (one signature a half,
    side by side, mapped the AND): the 16-byte path (P % 4 == 0, the second
    half at a 16-byte offset) and the one-window path (P = 101, 3);
    adversarial rows as halves and rows whose runs meet at the boundary."""
    r = np.random.default_rng(P)
    B = 5000
    ecs = r.integers(0, 40, (B, 2 * P)).astype(np.int32)
    ecs[r.random((B, 2 * P)) < 0.1] = -1
    ecs[:500] = np.repeat(r.integers(0, 4, (500, 1)), 2 * P, axis=1)
    valid = r.random((B, 2 * P)) < 0.95
    adv, adv_valid = adversarial_rows(P, C, seed=P)
    n = adv.shape[0] // 2 * 2
    ecs = np.concatenate([ecs, adv[:n].reshape(n // 2, 2 * P)])
    valid = np.concatenate([valid, adv_valid[:n].reshape(n // 2, 2 * P)])
    e, v = (torch.from_numpy(a).to(dev) for a in (ecs, valid))
    before = sig_cuda.read_signatures.launches
    got = sig_cuda.read_signatures(e, v, C, segments=2)
    torch.cuda.synchronize()
    assert sig_cuda.read_signatures.launches == before + 1
    want = sig_cuda.plain(e, v, C, 2)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[0].shape == (e.shape[0], 2 * C)
    halves = [sig_cuda.read_signatures(e[:, g * P:(g + 1) * P].contiguous(),
                                       v[:, g * P:(g + 1) * P].contiguous(),
                                       C) for g in range(2)]
    _eq(got[0], torch.cat([halves[0][0], halves[1][0]], dim=1))
    _eq(got[1], halves[0][1] & halves[1][1])


@pytest.mark.parametrize("C", [8, 16])
def test_accumulate_kernel_fusion_width(dev, world, C):
    """A1 at width 2C (16 and 32) on a table with no per-EC vector
    (num_ecs=0, every read through the CAS), as fusion mode folds its
    per-mate signatures: equal merged counts and fingerprint keys."""
    rng, seqs, idx = world
    di = DeviceIndex.from_host(idx["default"], dev)
    tables = [make_sig_table(12, 2 * C, num_ecs=0, device=dev)
              for _ in range(2)]
    for batch in range(3):
        ecs, valid = _paired_lanes(dev, rng, seqs, di, 4096)
        sig, mapped = sig_cuda.read_signatures(ecs, valid, C, segments=2)
        _fold_both(tables, sig, mapped, None, batch != 1)
    res = _same_tables(tables)
    assert res.sigs.shape[1] == 2 * C and res.overflow == 0
    assert tables[0].ec_count.shape == (1,)


@pytest.mark.parametrize("mode", ["strided_single", "strided_paired",
                                  "fusion", "fusion_strided"])
def test_strided_and_fusion_mapper_on_card_matches_cpu(dev, world, mode):
    """The Mapper on the card in strided and fusion mode equals the same
    Mapper on the CPU; strided runs launch K7 and no standalone K2."""
    rng, seqs, idx = world
    index = idx["default"]
    B, L = 1024, 100
    paired = mode != "strided_single"
    if paired:
        c1, c2, _ = simulate_packed_pairs(rng, seqs, 3, B, read_len=L,
                                          error_rate=0.01)
    else:
        c1, _ = simulate_packed_batches(rng, seqs, 3, B, read_len=L)
    ln = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], ln, w, codes2=c2[i] if paired else None,
                         lengths2=ln if paired else None) for i in range(3)]
    cfg = MapConfig(batch_size=B, sig_table_bits=14, paired_end=paired,
                    probe_stride=1 if mode == "fusion" else 4,
                    fusion_pairs=mode.startswith("fusion"))
    k2, k7 = (probe_cuda.lookup_ecs_aux.launches,
              strided_cuda.lookup_ecs_strided.launches)
    got = Mapper(index, cfg, device=dev).run(batches)
    k2, k7 = (probe_cuda.lookup_ecs_aux.launches - k2,
              strided_cuda.lookup_ecs_strided.launches - k7)
    assert (k2, k7) == ((3, 0) if mode == "fusion" else (0, 3))
    want = Mapper(index, cfg, device="cpu").run(batches)
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.mapped, got.overflow, got.collisions) == (
        want.mapped, want.overflow, want.collisions)
    assert got.mapped > 0.5 * got.total_reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 4])
def test_em_csr_fixed_point_in_pieces_equals_one_launch(dev, B, dtype,
                                                        monkeypatch):
    """A3's fixed point in pieces (``em.csr_fixed_point`` with a snapshot
    hook, each piece one block: the budget capped a block past the last
    piece's end) against one launch: the same bits, iteration count and
    flag, where it converges and where max_iters (not a multiple of
    check_every) stops it; a snapshot at every block end, one launch a
    piece."""
    from seekmer_tpu_torch.em import em as tem

    monkeypatch.setattr(tem, "SYNC_TARGET_S", 0.0)
    layout, n, eff, alpha = _gene_system(60, 0, B, dtype, seed=20 + B)
    lay = _on(dev, layout)
    for divide in ([False, True] if B == 1 else [False]):
        args = _csr_args(dev, layout, n, eff, alpha, divide)
        for cfg in (EMConfig(rel_tol=3e-2, max_iters=2000),
                    EMConfig(rel_tol=0.0, max_iters=100, check_every=7)):
            one = em_csr_cuda.em_fixed_point(*args, lay, cfg, divide)
            syncs = []
            before = em_csr_cuda.em_steps.launches
            got = tem.csr_fixed_point(*args, lay, cfg, divide,
                                      on_sync=lambda a, it: syncs.append(it))
            _eq(got[0], one[0])
            assert got[1:] == one[1:]
            C = cfg.check_every
            assert syncs == list(range(C, one[1], C))
            assert em_csr_cuda.em_steps.launches - before == len(syncs) + 1


_RESAMPLE = """
import sys
import numpy as np
import torch
from seekmer_tpu_torch.em.bootstrap import resample_counts

rng = np.random.default_rng(9)
counts = torch.from_numpy(rng.integers(0, 500, 3000).astype(
    np.float32)).to("cuda")
gen = torch.Generator(device="cuda")
gen.manual_seed(int(sys.argv[1]))
np.save(sys.argv[2], resample_counts(counts, 8, gen).cpu().numpy())
"""


def test_seeded_resample_on_card_repeats(dev, tmp_path):
    """The bootstrap's seeded resample on the card gives the same count
    matrix in two processes (a resumed bootstrap redraws it in a new
    one), and another from another seed."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)

    def draw(seed, name):
        out = str(tmp_path / f"{name}.npy")
        subprocess.run([sys.executable, "-c", _RESAMPLE, str(seed), out],
                       check=True, env=env, cwd=root, timeout=300)
        return np.load(out)

    a, b, c = draw(3, "a"), draw(3, "b"), draw(4, "c")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a.sum(axis=1) == a.sum(axis=1)[0]).all()


def test_pack_cache_batch_on_card_equals_ingest_batch(dev, world, tmp_path):
    """A cache hit's batch, uploaded from its memmap slices through pinned
    memory, equals on the card the ingest batch packed and uploaded the
    usual way; the mapper gives the same MapResult from both."""
    from seekmer_tpu_torch.io.fastq import batch_read_pairs_native
    from seekmer_tpu_torch.io.pack_cache import PackCacheSource, write_through
    from seekmer_tpu_torch.utils.prefetch import device_put_batches
    from seekmer_tpu_torch.utils.simulate import simulate_reads, write_fastq

    rng, seqs, idx = world
    sim = simulate_reads(rng, seqs, num_reads=700, read_len=100,
                         paired=True)
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(fq1, sim.reads1)
    write_fastq(fq2, sim.reads2)
    cfg = MapConfig(batch_size=256, paired_end=True)
    cache = str(tmp_path / "c.smpack")
    ingest = list(device_put_batches(
        batch_read_pairs_native([fq1], [fq2], cfg), dev))
    list(write_through(batch_read_pairs_native([fq1], [fq2], cfg), cache,
                       cfg, [fq1], [fq2]))
    hit = list(device_put_batches(iter(PackCacheSource(cache, cfg)), dev))
    assert len(hit) == len(ingest) == 3
    for h, g in zip(hit, ingest):
        for f in ("codes", "bad", "lengths", "weights", "codes2", "bad2",
                  "lengths2"):
            assert getattr(h, f).device.type == "cuda"
            _eq(getattr(h, f), getattr(g, f))
        assert h.pad_len == g.pad_len and h.n_real == g.n_real
    got = Mapper(idx["default"], cfg, device=dev).run(hit)
    want = Mapper(idx["default"], cfg, device=dev).run(ingest)
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)


UNROUTE_SENTINEL = -7  # an EC no lane may end up holding


def _poisoned(back, ret, counts, base, K, lane):
    """The slab with every unfilled slot sent to ``lane`` with the
    sentinel EC: a kernel that reads past an owner's filled run writes
    it."""
    f = route.filled(counts, base, K)
    return (torch.where(f, back, UNROUTE_SENTINEL),
            torch.where(f, ret, lane).to(torch.int32))


@pytest.mark.parametrize("rounds", [3, 1])
@pytest.mark.parametrize("D", [1, 2, 4, 64])
@pytest.mark.parametrize("N", [0, 1, 31, 5000, 70001])
def test_route_kernels(dev, D, N, rounds):
    """R1's first entry at a capacity K of three rounds, or of one (K at
    or above every count, as the ``[ps]`` phase routes): counts equal to
    the plain version's; each owner's round-0 slots hold min(count, K)
    distinct valid lanes of that owner with their hi and lo; the spill
    list holds the rest, their ranks K..count-1, disjoint from round 0's
    lanes; the spill entry's later slabs and R2's unroute put every lane's
    answer back in place, as the plain versions do, with every unfilled
    slot poisoned (a lane index and the sentinel EC); an empty batch
    zeroes the counts and launches nothing."""
    from seekmer_tpu_torch.ops.hash import hash_kmer
    from seekmer_tpu_torch.parallel.prefix_shard import capacity

    g = torch.Generator().manual_seed(N + D)
    hi = torch.randint(0, 1 << 26, (N,), generator=g, dtype=torch.int32)
    lo = torch.randint(0, 1 << 24, (N,), generator=g, dtype=torch.int32)
    valid = torch.rand(N, generator=g) < 0.8
    hi, lo, valid = hi.to(dev), lo.to(dev), valid.to(dev)
    *_, p_counts, _ = route.route_first(hi.cpu(), lo.cpu(), valid.cpu(), D,
                                        1)
    most = int(p_counts.max())
    K = (max(1, -(-most // 3)) if rounds == 3
         else max(1, most, capacity(N, D, 2.0)))
    before = (route_cuda.route_first.launches,
              route_cuda.route_spill.launches)
    s_hi, s_lo, ret, counts, spill = route_cuda.route_first(hi, lo, valid, D,
                                                            K)
    assert route_cuda.route_first.launches == before[0] + (N > 0)
    assert torch.equal(counts.cpu(), p_counts)
    n_spill = int((counts.long() - K).clamp(min=0).sum())
    assert rounds == 3 or n_spill == 0
    assert spill.shape[0] == 3 and n_spill <= spill.shape[1] <= max(N - K, 0)
    b = route.owner_bits(D)
    owner = torch.where(valid, hash_kmer(hi, lo) >> (32 - b) if b else
                        torch.zeros_like(hi, dtype=torch.int64), D)
    f = route.filled(counts, 0, K)
    lanes0 = ret[f].long()
    assert torch.equal(s_hi[f], hi[lanes0]) and torch.equal(s_lo[f],
                                                            lo[lanes0])
    sp = spill[:, :n_spill].long()
    for d in range(D):
        c = int(counts[d])
        got0 = lanes0[(torch.arange(D * K, device=dev)[f] // K) == d]
        assert got0.numel() == min(c, K)
        assert bool((owner[got0] == d).all())
        mine = sp[0][sp[1] == d]
        assert torch.equal(torch.sort(sp[2][sp[1] == d]).values,
                           torch.arange(K, max(c, K), device=dev))
        both = torch.cat([got0, mine])
        assert torch.equal(torch.sort(both).values,
                           torch.nonzero(owner == d).squeeze(1))
    # poison with a lane no slot fills, where there is one
    spare = torch.nonzero(~valid).squeeze(1)
    lane = int(spare[0]) if spare.numel() else 0
    ecs = torch.full((N,), -1, dtype=torch.int32, device=dev)
    p_ecs = ecs.clone()
    unroutes = route_cuda.unroute.launches
    for j in range(rounds):
        base = j * K
        slab = ((s_hi, s_lo, ret) if j == 0 else route_cuda.route_spill(
            hi, lo, spill, n_spill, D, base, K))
        if j:
            want = route.route_spill(hi, lo, spill, n_spill, D, base, K)
            f = route.filled(counts, base, K)
            for a, b in zip(slab, want):
                assert torch.equal(a[f], b[f])
        back, r = _poisoned((slab[0] ^ slab[1]) & 0xFFFF, slab[2], counts,
                            base, K, lane)
        route_cuda.unroute(back, r, counts, base, K, ecs)
        route.unroute(back, r, counts, base, K, p_ecs)
        assert not bool((ecs == UNROUTE_SENTINEL).any())
    assert route_cuda.unroute.launches == unroutes + rounds * (D * K > 0)
    assert route_cuda.route_spill.launches == before[1] + (
        (rounds - 1) * (n_spill > 0))
    assert torch.equal(ecs, p_ecs)
    assert torch.equal(ecs, torch.where(valid, (hi ^ lo) & 0xFFFF, -1))


@pytest.mark.parametrize("K", [1, 31, 2049])
@pytest.mark.parametrize("D", [1, 4, 64])
def test_unroute_kernel_capacities(dev, D, K):
    """R2 alone on slabs made here, at capacities that are not a multiple
    of a block's 2,048 slots: owners with no lanes, owners whose run fills
    the round, owners that end inside it or before it; rounds 0 and 1.
    Every unfilled slot is poisoned with a lane that no slot fills and the
    sentinel EC. Equal to the plain version; each routed lane of the round
    gets its EC, every other lane stays -1."""
    rng = np.random.default_rng(D * 4099 + K)
    counts = rng.integers(0, 2 * K + 2, D)
    counts[0] = K + K // 2 + 1  # past round 0, ending inside round 1
    counts[2::3] = 0  # owners with no lanes
    counts[1::5] = K  # owners whose run fills round 0
    routed = int(counts.sum())
    N = routed + 5  # the last lanes route nowhere
    lanes = rng.permutation(routed)
    starts = np.cumsum(counts) - counts
    t_counts = torch.from_numpy(counts.astype(np.int32)).to(dev)
    for base in (0, K):
        ret = np.zeros(D * K, np.int32)
        want = np.full(N, -1, np.int32)
        for d in range(D):
            run = lanes[starts[d]:starts[d] + counts[d]][base:base + K]
            ret[d * K:d * K + run.size] = run
            want[run] = run * 3 + 1
        t_ret = torch.from_numpy(ret).to(dev)
        back, r = _poisoned(t_ret * 3 + 1, t_ret, t_counts, base, K, N - 1)
        before = route_cuda.unroute.launches
        got = route_cuda.unroute(back, r, t_counts, base, K,
                                 torch.full((N,), -1, dtype=torch.int32,
                                            device=dev))
        assert route_cuda.unroute.launches == before + 1
        p = route.unroute(back.cpu(), r.cpu(), t_counts.cpu(), base, K,
                          torch.full((N,), -1, dtype=torch.int32))
        assert torch.equal(got.cpu(), p)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
