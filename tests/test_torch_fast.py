"""Fast mode (two-phase sampled probing) of the port against the JAX package.

- The plain ``ops/probe.two_phase_signatures`` against JAX
  ``two_phase_signatures`` on the same numpy reads (errors, N bases, ragged
  lengths, junk reads), single-end and paired, at strides 2, 4 and 16; JAX
  at fallback caps 1.0 and 1/64, so its residual rounds run. ``sig`` and
  ``mapped`` must be equal exactly, rows of unmapped reads included.
- (``tests/test_torch_fast_mapper.py``: the port's ``Mapper`` against the
  JAX ``Mapper``.)
- The cases of ``tests/test_map_device.py``'s fast-mode tests, run on the
  port (fast against dense, invariants, the cap that changes nothing).
- Numpy models of the arithmetic of K5 (``csrc/sample.cu``: a sampled
  window from the staged row bytes, the closed-form valid-window test,
  the warp's plan, and its tiles whole: compaction of the valid keys
  into lookup rounds, the reduce and classification a lane a segment,
  the slots and the units' rows) and K6 (``csrc/merge.cu``: the merge by
  rank of the lists' first 4 values in registers, the two-way merge of
  longer lists) against the plain
  versions; the kernels themselves are held to the plain versions on the
  card (``tests/test_torch_cuda.py``).
- ``infer --probe-sample 4 --device cpu`` against the JAX CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu import cli as jcli
from seekmer_tpu.config import MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import ReadBatch, batch_read_pairs, batch_reads
from seekmer_tpu.io.writer import read_abundance
from seekmer_tpu.map.driver import DeviceIndex as JDeviceIndex
from seekmer_tpu.map.signature import read_signatures as j_read_signatures
from seekmer_tpu.ops.kmer_pack import pack_canonical as j_pack
from seekmer_tpu.ops.probe import two_phase_signatures as j_two_phase
from seekmer_tpu.utils.simulate import (isoform_transcriptome,
                                        random_transcriptome,
                                        simulate_packed_pairs,
                                        simulate_reads, write_fastq)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch import encoding as enc
from seekmer_tpu_torch.config import MapConfig as TMapConfig
from seekmer_tpu_torch.map.driver import DeviceIndex, Mapper
from seekmer_tpu_torch.map.signature import SIG_PAD, read_signatures
from seekmer_tpu_torch.ops import fast_cuda, probe
from seekmer_tpu_torch.ops.kmer_pack import pack_canonical
from tests.test_torch_pack_lookup import PAIRS, U64, _brev64
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)

L = 96  # one length bucket for the direct calls: 90 bp reads
C = 8


def _ragged(rng, reads):
    """Mixed lengths and a few N bases."""
    out = []
    for r in reads:
        r = r[:int(rng.integers(20, len(r) + 1))]
        if rng.random() < 0.1:
            j = int(rng.integers(0, len(r)))
            r = r[:j] + "N" + r[j + 1:]
        out.append(r)
    return out


@pytest.fixture(scope="module")
def world():
    """An index and 360 read pairs: 200 simulated with 2% errors, 160 junk
    (no indexed k-mer: every valid segment of theirs is a fallback unit,
    enough units that JAX's 1/64 cap takes residual rounds)."""
    rng = np.random.default_rng(41)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=700,
        shared_prefix_frac=0.6)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=200, read_len=90, paired=True,
                         mean_frag=180.0, error_rate=0.02)
    junk = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(320)]
    return (index, _ragged(rng, list(sim.reads1) + junk[:160]),
            _ragged(rng, list(sim.reads2) + junk[160:]))


def _codes(reads):
    codes = np.full((len(reads), L), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = enc.seq_to_codes(r)
        lengths[i] = len(r)
    return codes, lengths


def _mates(segs):
    """(packed, bad, lengths) tensors of each segment's codes."""
    return [tuple(torch.from_numpy(a) for a in (*enc.pack_codes_2bit(c), ln))
            for c, ln in segs]


def _geo(index):
    di = DeviceIndex.from_host(port_index(index), "cpu")
    return di.table, di.main_slots, di.stash, di.stash_slots, di.bucket


def _jax_two_phase(index, segs, stride, frac):
    """JAX ``two_phase_signatures`` after JAX's pack, jitted as its map step
    runs it."""
    di = JDeviceIndex.from_host(index)
    k = index.k

    @jax.jit
    def run(table, stash, codes, lengths):
        packs = [j_pack(c, ln, k) for c, ln in zip(codes, lengths)]
        hi, lo, valid = (jnp.concatenate([p[i] for p in packs], axis=1)
                         for i in range(3))
        return j_two_phase(
            hi, lo, valid, list(zip(codes, lengths)),
            lambda c, ln: j_pack(c, ln, k), table, di.main_slots, stash,
            di.stash_slots, di.bucket, stride, C, j_read_signatures,
            int(SIG_PAD), fallback_frac=frac,
            seg_widths=[L - k + 1] * len(segs))

    sig, mapped = run(di.table, di.stash, [jnp.asarray(c) for c, _ in segs],
                      [jnp.asarray(ln) for _, ln in segs])
    return np.asarray(sig), np.asarray(mapped)


@pytest.mark.parametrize("stride", [2, 4, 16])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_two_phase_plain_matches_jax(world, paired, stride):
    index, r1, r2 = world
    segs = [_codes(r1)] + ([_codes(r2)] if paired else [])
    mates = _mates(segs)
    sig, mapped = probe.two_phase_signatures(mates, L, index.k, stride, C,
                                             *_geo(index))
    _, slot, units = probe.sample_classify(mates, L, index.k, stride,
                                           *_geo(index))
    # more units than JAX's smallest cap (128) takes in one round
    assert units[0].shape[0] > 128
    assert bool(mapped.any()) and not bool(mapped.all())
    for frac in (1.0, 1 / 64):
        want_sig, want_mapped = _jax_two_phase(index, segs, stride, frac)
        np.testing.assert_array_equal(sig.numpy(), want_sig)
        np.testing.assert_array_equal(mapped.numpy(), want_mapped)


def _batches(reads1, reads2, cfg):
    b = [r.encode() for r in reads1]
    if reads2 is None:
        return list(batch_reads(b, cfg))
    return list(batch_read_pairs(zip(b, [r.encode() for r in reads2]), cfg))


def _same_result(got, want):
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.total_reads, got.mapped, got.overflow, got.collisions) == (
        want.total_reads, want.mapped, want.overflow, want.collisions)


# ---- the fast-mode cases of tests/test_map_device.py, on the port ---------


def _sig_dict(result):
    return {tuple(row[row != SIG_PAD].tolist()): int(n)
            for row, n in zip(result.sigs, result.sig_counts)}


def _port_run(index, cfg, batches):
    return Mapper(port_index(index), port_config(cfg), device="cpu").run(
        batches)


def test_fast_single_ec_world_exact():
    """Every read inside one EC run resolves in phase 1 and equals dense."""
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    index = build_index_from_seqs(["t0"], [seq])
    sim = simulate_reads(rng, [seq], num_reads=300, read_len=100,
                         error_rate=0.0)
    res = {}
    for sample in (0, 4):
        cfg = MapConfig(batch_size=128, sig_table_bits=12,
                        probe_sample=sample)
        res[sample] = _port_run(index, cfg, _batches(sim.reads1, None, cfg))
    assert _sig_dict(res[4]) == _sig_dict(res[0])
    assert res[4].mapped == res[0].mapped == 300


@pytest.fixture(scope="module")
def shared_prefix_world():
    rng = np.random.default_rng(99)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=150, max_len=800,
        shared_prefix_frac=0.6)
    return build_index_from_seqs(names, seqs), seqs


def test_fast_ambiguous_reads_fall_back_exact(shared_prefix_world):
    """At stride 2 on error-free reads (plus junk), fast equals dense."""
    index, seqs = shared_prefix_world
    rng = np.random.default_rng(17)
    sim = simulate_reads(rng, seqs, num_reads=400, read_len=100,
                         error_rate=0.0)
    junk = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(40)]
    reads = list(sim.reads1) + junk
    res = {}
    for sample in (0, 2):
        cfg = MapConfig(batch_size=128, sig_table_bits=12,
                        max_ecs_per_read=8, probe_sample=sample)
        res[sample] = _port_run(index, cfg, _batches(reads, None, cfg))
    assert res[2].total_reads == res[0].total_reads
    assert _sig_dict(res[2]) == _sig_dict(res[0])
    assert res[2].mapped == res[0].mapped


def test_fast_signatures_are_dense_subsets():
    """Read by read: a fast signature is the dense one or a non-empty
    subset of it; a fast-unmapped read is dense-unmapped or complex."""
    rng = np.random.default_rng(23)
    names, seqs = random_transcriptome(
        rng, num_transcripts=30, min_len=150, max_len=600,
        shared_prefix_frac=0.8)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=256, read_len=100,
                         error_rate=0.02)
    codes = np.full((256, 100), 4, np.uint8)
    for i, r in enumerate(sim.reads1):
        codes[i, :len(r)] = enc.seq_to_codes(r)
    lengths = np.full(256, 100, np.int32)
    hi, lo, valid = pack_canonical(torch.from_numpy(codes),
                                   torch.from_numpy(lengths), index.k)
    geo = _geo(index)
    sig_ref, mapped_ref = read_signatures(probe.lookup_ecs(hi, lo, valid,
                                                           *geo), valid, 16)
    sig, mapped = probe.two_phase_signatures(
        _mates([(codes, lengths)]), 100, index.k, 2, 16, *geo)
    for i in range(256):
        ref = set(sig_ref[i].tolist()) - {SIG_PAD}
        got = set(sig[i].tolist()) - {SIG_PAD}
        if got != ref:
            assert got and got < ref, (i, got, ref)
        if not mapped[i]:
            assert not mapped_ref[i] or len(ref) > 16


def _isoform_pairs(rng, batches, error_rate):
    names, seqs, genes = isoform_transcriptome(rng, num_genes=10)
    c1, c2, _ = simulate_packed_pairs(rng, seqs, batches, 128, read_len=96,
                                      error_rate=error_rate)
    index = build_index_from_seqs(names, seqs, genes=genes)
    ln = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    return index, [ReadBatch(c1[i], ln, w, codes2=c2[i], lengths2=ln)
                   for i in range(batches)]


def test_fast_paired_matches_dense_on_clean_pairs(rng):
    index, batches = _isoform_pairs(rng, 1, 0.0)
    res = {}
    for sample in (0, 2):
        cfg = MapConfig(batch_size=128, paired_end=True, sig_table_bits=12,
                        probe_sample=sample)
        res[sample] = _port_run(index, cfg, batches)
    assert _sig_dict(res[2]) == _sig_dict(res[0])


def test_fast_zero_hit_mate_reprobed_densely(rng):
    """A fallback pair's mate with no sampled hit is re-probed densely: its
    hits between the samples (windows 1..15 at stride 16) are in the pair's
    signature, which equals dense's three ECs."""
    t0 = "".join(rng.choice(list("ACGT"), size=600))
    t1 = t0[:300] + "".join(rng.choice(list("ACGT"), size=300))
    index = build_index_from_seqs(["t0", "t1"], [t0, t1])
    mate1 = t0[220:316]  # shared prefix, then t0's unique tail
    u = t1[350:390]
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    mate2 = flip[u[0]] + u[1:] + "".join(rng.choice(list("ACGT"), size=56))
    ln = np.full(1, 96, np.int32)
    w = np.ones(1, np.int32)
    batch = ReadBatch(enc.seq_to_codes(mate1)[None], ln, w,
                      codes2=enc.seq_to_codes(mate2)[None], lengths2=ln)
    res = {}
    for sample in (0, 16):
        cfg = MapConfig(batch_size=1, paired_end=True, sig_table_bits=10,
                        probe_sample=sample)
        res[sample] = _port_run(index, cfg, [batch])
    (sig0,) = _sig_dict(res[0]).keys()
    assert len(sig0) == 3
    assert _sig_dict(res[16]) == _sig_dict(res[0])


def test_fallback_cap_changes_nothing(rng):
    """Every sample_fallback_frac the config takes gives the same result
    (the port re-probes all units in one pass); others are refused."""
    index, batches = _isoform_pairs(rng, 2, 0.01)
    res = []
    for frac in (0.0, 1 / 64, 0.5, 1.0):
        cfg = MapConfig(batch_size=128, paired_end=True, sig_table_bits=12,
                        probe_sample=4, sample_fallback_frac=frac)
        res.append(_port_run(index, cfg, batches))
    for r in res[1:]:
        _same_result(r, res[0])
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="sample_fallback_frac"):
            TMapConfig(probe_sample=4, sample_fallback_frac=bad)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_all_invalid_segment_is_never_a_unit(paired):
    """A segment with no valid window (all N) is never re-probed; a read
    made only of such segments is unmapped."""
    rng = np.random.default_rng(31)
    names, seqs = random_transcriptome(rng, num_transcripts=10)
    index = build_index_from_seqs(names, seqs)
    B = 8
    dead = (np.full((B, 100), 4, np.uint8), np.full(B, 100, np.int32))
    segs = [dead]
    if paired:  # mate 2: junk with valid windows and no hit
        junk = np.stack([enc.seq_to_codes("".join(rng.choice(list("ACGT"),
                                                              size=100)))
                         for _ in range(B)])
        segs.append((junk, np.full(B, 100, np.int32)))
    mates = _mates(segs)
    _, slot, units = probe.sample_classify(mates, 100, index.k, 4,
                                           *_geo(index))
    assert (slot[:, 0] == -1).all()
    assert units[0].shape[0] == (B if paired else 0)
    _, mapped = probe.two_phase_signatures(mates, 100, index.k, 4, 8,
                                           *_geo(index))
    assert not mapped.any()


# ---- numpy models of the kernels' arithmetic --------------------------------

M64 = (1 << 64) - 1


def bytes8(span, off):
    """``csrc/sample.cu`` ``bytes8``: the 8 bytes of a staged span from byte
    ``off``, little-endian, from two aligned 8-byte words and a funnel
    shift."""
    w, sh = off >> 3, (off & 7) * 8
    lo = int.from_bytes(bytes(span[8 * w:8 * w + 8]), "little")
    hi = int.from_bytes(bytes(span[8 * w + 8:8 * w + 16]), "little")
    return ((lo >> sh) | (hi << (64 - sh))) & M64 if sh else lo


def has_window_model(span, off, n, k):
    """K5's closed-form test that the first n bases of a bad-bitmask row
    (from byte ``off`` of ``span``) hold k good bases in a row: 64 bases a
    step, doubling shift-ands inside the word, the run carried across
    words."""
    carry, w = 0, 0
    while 64 * w < n:
        good = ~bytes8(span, off + 8 * w) & M64
        if n - 64 * w < 64:
            good &= (1 << (n - 64 * w)) - 1
        full = good == M64
        zeros = ~good & M64
        trail = 64 if full else (zeros & -zeros).bit_length() - 1
        if carry + trail >= k:
            return True
        r, span_ = good, 1
        while span_ < k:
            sh = min(span_, k - span_)
            r &= r >> sh
            span_ += sh
        if r:
            return True
        carry = carry + 64 if full else 64 - zeros.bit_length()
        w += 1
    return False


def _staged(rng, rows, misalign):
    """A batch's rows as K5 stages a span of them: the rows' bytes at
    ``misalign`` bytes into a 16-byte chunk, garbage before and after
    (the bytes past a row are other rows or the region's padding, never
    zeros)."""
    flat = np.ascontiguousarray(rows).reshape(-1)
    span = rng.integers(0, 256, size=misalign + flat.size + 48).astype(
        np.uint8)
    span[misalign:misalign + flat.size] = flat
    return span


def window_model(span, pre, bspan, bpre, c, k, length):
    """K5's window at column c of a row staged at byte ``pre`` of ``span``
    (its bad bitmask at ``bpre`` of ``bspan``), as ``csrc/sample.cu``
    computes it: the 8 bytes from row byte c / 4 shifted by 2 (c % 4)
    bases, the 8 bitmask bytes from byte c / 8 shifted by c % 8, then
    ``kmer.cuh``'s closed form at q = 0 without clearing bad bases (a
    window with one is invalid and never looked up). Bytes past the row
    are whatever follows it. Returns None for an invalid window, else its
    (hi, lo)."""
    nb = (bytes8(bspan, bpre + (c >> 3)) >> (c & 7)) & ((1 << k) - 1)
    if c + k > length or nb:
        return None
    W = np.array([bytes8(span, pre + (c >> 2)) >> (2 * (c & 3))], U64)
    R = int(~W[0] & U64((1 << 2 * k) - 1))
    F = int(_brev64(((W >> U64(1)) & PAIRS)
                    | ((W & PAIRS) << U64(1)))[0]) >> (64 - 2 * k)
    canon, lo_bits = min(F, R), 2 * (k - k // 2)
    return canon >> lo_bits, canon & ((1 << lo_bits) - 1)


@pytest.mark.parametrize("k", range(1, 30))
def test_sampled_window_model_matches_jax(k):
    """The model of K5's window arithmetic against the port's plain
    ``pack_canonical`` (held to JAX's in ``test_torch_pack_lookup.py``) at
    the sampled columns, on rows not a multiple of 4 or 8 bases long, read
    from a staged span that starts inside a 16-byte chunk and holds
    garbage past its rows; and its closed-form valid-window test against
    the plain valid windows."""
    r = np.random.default_rng(k)
    L_ = 101
    codes = r.integers(0, 4, size=(40, L_)).astype(np.uint8)
    codes[r.random((40, L_)) < 0.03] = 4
    lengths = r.integers(max(k - 3, 1), L_ + 1, size=40).astype(np.int32)
    lengths[:3] = [L_, k, k - 1]
    for i, n in enumerate(lengths):
        codes[i, n:] = 4
    packed, bad = enc.pack_codes_2bit(codes)
    P = L_ - k + 1
    hi, lo, valid = (a.numpy() for a in pack_canonical(
        torch.from_numpy(codes), torch.from_numpy(lengths), k))
    pre, bpre = int(r.integers(0, 16)), int(r.integers(0, 16))
    span, bspan = _staged(r, packed, pre), _staged(r, bad, bpre)
    for stride in (2, 16):
        for c in probe.sample_columns(P, stride):
            for i in range(40):
                got = window_model(span, pre + i * packed.shape[1], bspan,
                                   bpre + i * bad.shape[1], c, k,
                                   min(int(lengths[i]), L_))
                assert (got is not None) == valid[i, c]
                if got is not None:
                    assert got == (hi[i, c], lo[i, c])
    scan = [has_window_model(bspan, bpre + i * bad.shape[1],
                             min(int(lengths[i]), L_), k) for i in range(40)]
    np.testing.assert_array_equal(scan, valid.any(axis=1))


@pytest.mark.parametrize("k", range(1, 30))
def test_has_window_closed_form(k):
    """The closed-form valid-window test against the plain
    ``valid.any(dim=1)`` for random bitmasks (sparse and dense bad bases,
    runs of exactly k - 1, k and k + 1 good bases, across 64-base words),
    each length 0..L on one row, at L from 25 to 256."""
    r = np.random.default_rng(100 + k)
    for L_ in (25, 31, 63, 64, 65, 100, 128, 129, 200, 256):
        if L_ < k:
            continue
        B = L_ + 1
        density = r.choice([0.02, 0.1, 0.3, 0.7], size=B)
        bad = r.random((B, L_)) < density[:, None]
        for i in range(8):  # one run of k - 1 + i % 3 good bases
            run = k - 1 + i % 3
            at = int(r.integers(0, max(L_ - run, 0) + 1))
            bad[i] = True
            bad[i, at:at + run] = False
        codes = np.where(bad, 4, 0).astype(np.uint8)
        lengths = r.permutation(B).astype(np.int32)  # each of 0..L once
        _, bad_rows = enc.pack_codes_2bit(codes)
        want = pack_canonical(torch.from_numpy(codes),
                              torch.from_numpy(lengths), k)[2].any(dim=1)
        pre = int(r.integers(0, 16))
        span = _staged(r, bad_rows, pre)
        got = [has_window_model(span, pre + i * bad_rows.shape[1],
                                min(int(lengths[i]), L_), k)
               for i in range(B)]
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"L={L_}")


def sample_model(mates, L_, k, stride, geo, seed=0):
    """K5 as ``csrc/sample.cu`` runs it, warp tile by warp tile of
    ``fast_cuda.sample_plan``: the tile's rows staged from inside a 16-byte
    chunk, the sampled lanes 32 a step with their validity ballots, the
    valid keys compacted at their ranks and looked up in rounds of 32, a
    segment's ECs found at the ranks the ballots' prefix counts give, the
    reduce and classification a lane a segment, the closed-form window
    test, and the units' slots consecutive from a running count (tile
    order: here equal to the plain order) with their rows copied in
    vectors of the largest of 8, 4, 2, 1 bytes that divides a row.
    Returns (single, slot, units) as ``probe.sample_classify``."""
    rng = np.random.default_rng(seed)
    n_seg = len(mates)
    plan = fast_cuda.sample_plan(L_, k, stride, n_seg)
    S, s, P = plan.S, max(stride, 2), L_ - k + 1
    Sp, Sb = (L_ + 3) // 4, (L_ + 7) // 8
    packed = [m[0].numpy() for m in mates]
    bad = [m[1].numpy() for m in mates]
    lens = [m[2].numpy() for m in mates]
    B = lens[0].shape[0]
    single = np.zeros((B, n_seg), np.int32)
    slot = np.zeros((B, n_seg), np.int32)
    u_packed = np.zeros((B * n_seg, Sp), np.uint8)
    u_bad = np.zeros((B * n_seg, Sb), np.uint8)
    u_len = np.zeros(B * n_seg, np.int32)
    count = 0
    for b0 in range(0, B, plan.reads):
        R = min(plan.reads, B - b0)
        nseg, lanes = R * n_seg, R * n_seg * S
        assert nseg <= 32 and lanes <= plan.keys
        spans = []
        for g in range(n_seg):
            pp, pb = (int(x) for x in rng.integers(0, 16, size=2))
            spans.append((_staged(rng, packed[g][b0:b0 + R], pp), pp,
                          _staged(rng, bad[g][b0:b0 + R], pb), pb))
        seg_len = [max(0, min(int(lens[sg % n_seg][b0 + sg // n_seg]), L_))
                   for sg in range(nseg)]
        keys, bits = [], []
        for j in range(-(-lanes // 32)):
            ballot = 0
            for lane in range(32):
                q = 32 * j + lane
                if q >= lanes:
                    continue
                sg = q // S
                r, g = sg // n_seg, sg % n_seg
                span, pp, bspan, pb = spans[g]
                key = window_model(span, pp + r * Sp, bspan, pb + r * Sb,
                                   min((q - sg * S) * s, P - 1), k,
                                   seg_len[sg])
                if key is not None:
                    ballot |= 1 << lane
                    keys.append(key)
            bits.append(ballot)
        ecs = []
        for base in range(0, len(keys), 32):  # full rounds but the last
            hk = torch.tensor([h for h, _ in keys[base:base + 32]],
                              dtype=torch.int32)
            lk = torch.tensor([x for _, x in keys[base:base + 32]],
                              dtype=torch.int32)
            ecs += probe.lookup_ecs(hk, lk, torch.ones_like(hk, dtype=bool),
                                    *geo).tolist()

        def valid_before(pos):
            n = sum(bin(bits[j]).count("1") for j in range(pos >> 5))
            if pos & 31:
                n += bin(bits[pos >> 5] & ((1 << (pos & 31)) - 1)).count("1")
            return n

        mx, ok = [], []
        for sg in range(nseg):
            hits = [e for e in ecs[valid_before(sg * S):
                                   valid_before((sg + 1) * S)] if e >= 0]
            mx.append(max(hits, default=-1))
            ok.append(not hits or min(hits) == mx[-1])
        needy = []
        for sg in range(nseg):
            r, g = sg // n_seg, sg % n_seg
            rd = range(r * n_seg, r * n_seg + n_seg)
            resolved = (any(mx[x] >= 0 for x in rd)
                        and all(ok[x] for x in rd))
            single[b0 + r, g] = mx[sg] if ok[sg] and mx[sg] >= 0 else SIG_PAD
            _, _, bspan, pb = spans[g]
            need = (not resolved and (not ok[sg] or mx[sg] < 0)
                    and has_window_model(bspan, pb + r * Sb, seg_len[sg], k))
            slot[b0 + r, g] = count + len(needy) if need else -1
            if need:
                u_len[count + len(needy)] = lens[g][b0 + r]
                needy.append(sg)
        for dst, w, which in ((u_packed, Sp, 0), (u_bad, Sb, 2)):
            V = 8 if w % 8 == 0 else 4 if w % 4 == 0 else 2 if w % 2 == 0 \
                else 1
            flat = dst.reshape(-1)
            for t in range(len(needy) * (w // V)):
                i, o = divmod(t, w // V)
                o *= V
                sg = needy[i]
                r, g = sg // n_seg, sg % n_seg
                v = bytes8(spans[g][which], spans[g][which + 1] + r * w + o)
                at = (count + i) * w + o
                flat[at:at + V] = np.frombuffer(
                    v.to_bytes(8, "little")[:V], np.uint8)
        count += len(needy)
    return (torch.from_numpy(single), torch.from_numpy(slot),
            tuple(torch.from_numpy(a[:count])
                  for a in (u_packed, u_bad, u_len)))


@pytest.fixture(scope="module")
def wide_world():
    """An index at k = 29 and 120 read pairs of 40-256 bp in the 256 length
    bucket (errors, N bases, junk, an all-N row every 17)."""
    from seekmer_tpu_torch.config import IndexConfig
    from seekmer_tpu_torch.index.build import \
        build_index_from_seqs as t_build

    rng = np.random.default_rng(57)
    names, seqs = random_transcriptome(rng, num_transcripts=20, min_len=400,
                                       max_len=900, shared_prefix_frac=0.6)
    index = t_build(names, seqs, cfg=IndexConfig(k=29))
    sim = simulate_reads(rng, seqs, num_reads=90, read_len=256, paired=True,
                         mean_frag=400.0, error_rate=0.02)
    junk = ["".join(rng.choice(list("ACGT"), size=256)) for _ in range(60)]
    segs = []
    for reads in (list(sim.reads1) + junk[:30], list(sim.reads2) + junk[30:]):
        codes = np.full((len(reads), 256), 4, np.uint8)
        lengths = np.zeros(len(reads), np.int32)
        for i, rd in enumerate(reads):
            rd = rd[:int(rng.integers(40, 257))]
            codes[i, :len(rd)] = enc.seq_to_codes(rd)
            lengths[i] = len(rd)
        codes[rng.random(codes.shape) < 0.005] = 4
        codes[::17] = 4
        segs.append((codes, lengths))
    di = DeviceIndex.from_host(index, "cpu")
    return index.k, segs, (di.table, di.main_slots, di.stash,
                           di.stash_slots, di.bucket)


@pytest.mark.parametrize("case", ["single-16", "paired-16", "paired-8",
                                  "paired-2", "wide-paired-2",
                                  "wide-single-3"])
def test_sample_model_matches_plain(world, wide_world, case):
    """The model of K5's warp tiles against the plain ``sample_classify``:
    single ECs, slots and the units' rows equal, unit order included; at L
    96 and k = 25 (B = 360 is not a multiple of the reads a warp takes at
    s = 8 or 16), and at L 256, k = 29, s = 2 and 3, where a segment has
    more than 32 sampled columns and a warp takes one read."""
    wide = case.startswith("wide")
    paired = "paired" in case
    stride = int(case.rsplit("-", 1)[1])
    if wide:
        k, segs, geo = wide_world
        L_ = 256
    else:
        index, r1, r2 = world
        k, L_, geo = index.k, L, _geo(index)
        segs = [_codes(r1), _codes(r2)]
    mates = _mates(segs[:2 if paired else 1])
    plan = fast_cuda.sample_plan(L_, k, stride, len(mates))
    assert (plan.S > 32) == (stride <= 3)
    assert (plan.reads == 1) == (plan.S * len(mates) > 128)
    got = sample_model(mates, L_, k, stride, geo, seed=stride)
    want = probe.sample_classify(mates, L_, k, stride, *geo)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert 0 < want[2][0].shape[0] < mates[0][0].shape[0] * len(mates)


def _staged_need(n):
    """Shared memory a staged span of n bytes touches at most: copied in
    16-byte chunks from the chunk that holds its first byte (up to 15
    bytes in), and read 16 bytes at a time from the 8-byte word that
    holds a window's first byte."""
    return max(16 * -(-(15 + n) // 16), 8 * ((15 + n - 1) // 8) + 16)


@pytest.mark.parametrize("n_seg", [1, 2])
def test_sample_plan(n_seg):
    """K5's warp plan for every (L, k, s) on a grid that covers the lengths
    the wrapper takes: S is the number of sampled columns (the kernel's
    closed form of it), a tile has at least one read, at most 32 segments
    (a lane a segment) and as many reads as fit 256 sampled lanes; its
    keys hold every sampled lane with less than a round to spare (rounds
    of 32 loop over a segment when S > 32); each part of its carve has
    the bytes the kernel touches there, aligned for its loads, and the
    shared memory of a block of its warps fits the card."""
    for k in range(1, 30):
        for L_ in [*range(k, 300, 7), 512, 1000, 1024]:
            if L_ < k:
                continue
            P = L_ - k + 1
            for s in (2, 3, 4, 8, 16, 64, 1000):
                p = fast_cuda.sample_plan(L_, k, s, n_seg)
                assert p.S == len(probe.sample_columns(P, s)) == (
                    (P + s - 1) // s + ((P - 1) % s != 0))
                lanes = p.reads * n_seg * p.S
                assert 1 <= p.reads and p.reads * n_seg <= 32
                assert p.reads == 1 or lanes <= fast_cuda.SAMPLED_LANES
                assert (p.reads * n_seg == 32 or p.reads == 1
                        or lanes + n_seg * p.S > fast_cuda.SAMPLED_LANES)
                assert p.keys % 32 == 0 and lanes <= p.keys < lanes + 32
                rows = (p.reads * ((L_ + 3) // 4), p.reads * ((L_ + 7) // 8))
                assert p.bad_at >= _staged_need(rows[0])
                assert p.mate_at - p.bad_at >= _staged_need(rows[1])
                assert p.keys_at >= n_seg * p.mate_at
                assert p.bits_at - p.keys_at >= 8 * p.keys
                assert p.useg_at - p.bits_at >= 4 * (p.keys // 32)
                assert 32 <= p.warp_bytes - p.useg_at < 48
                assert p.bad_at % 16 == p.mate_at % 16 == 0  # 16-byte copies
                assert p.keys_at % 8 == p.bits_at % 4 == 0
                assert p.warp_bytes % 16 == 0
                assert 1 <= p.warps <= fast_cuda.MAX_WARPS
                assert p.warps * p.warp_bytes <= fast_cuda.SMEM_BLOCK
    # the shapes the map step runs: config 2 at s = 16 and 8, config 1
    assert fast_cuda.sample_plan(128, 25, 16, 2)[:3] == (8, 16, 256)
    assert fast_cuda.sample_plan(128, 25, 8, 2)[:3] == (14, 9, 256)
    assert fast_cuda.sample_plan(128, 25, 16, 1)[:3] == (8, 32, 256)


def merge_model(single, slot, sig_d, mapped_d, C_):
    """K6's loop: a two-way merge of each read's (at most two) sorted
    distinct segment lists."""
    B, n_seg = single.shape
    sig = np.full((B, C_), SIG_PAD, np.int32)
    mapped = np.zeros(B, bool)
    for b in range(B):
        lists, forced = [], False
        for g in range(n_seg):
            s = int(slot[b, g])
            if s >= 0:
                lists.append(list(sig_d[s]))
                forced |= sig_d[s, 0] != SIG_PAD and not mapped_d[s]
            else:
                lists.append([int(single[b, g])])
        if n_seg == 1:
            lists.append([])
        i0 = i1 = n = 0
        while True:
            a = lists[0][i0] if i0 < len(lists[0]) else SIG_PAD
            c = lists[1][i1] if i1 < len(lists[1]) else SIG_PAD
            v = min(a, c)
            if v == SIG_PAD:
                break
            i0 += a == v
            i1 += c == v
            if n < C_:
                sig[b, n] = v
            n += 1
        mapped[b] = 0 < n <= C_ and not forced
    return sig, mapped


def _staging(r, B, n_seg, C_, n_vals, unit_share=0.4):
    """Random merge inputs: single ECs (some SIG_PAD), units whose rows
    are empty, full (C values), mapped or complex (more than C distinct,
    unmapped), drawing from n_vals values so that lists share some."""
    single = np.where(r.random((B, n_seg)) < 0.7,
                      r.integers(0, n_vals, (B, n_seg)),
                      SIG_PAD).astype(np.int32)
    need = r.random((B, n_seg)) < unit_share
    single[need] = SIG_PAD
    nu = int(need.sum())
    slot = np.full((B, n_seg), -1, np.int32)
    slot[need] = np.arange(nu)
    sig_d = np.full((nu, C_), SIG_PAD, np.int32)
    mapped_d = np.zeros(nu, bool)
    for u in range(nu):
        n = int(r.choice([0, C_, int(r.integers(0, C_ + 3))]))
        vals = np.sort(r.choice(max(n_vals, n), size=n, replace=False))
        sig_d[u, :min(n, C_)] = vals[:C_]
        mapped_d[u] = 0 < n <= C_
    return single, slot, sig_d, mapped_d


@pytest.mark.parametrize("n_seg", [1, 2])
def test_merge_model_and_unit_order(n_seg):
    """Random staging: single ECs, units with overlapping, complex (more
    than C distinct, unmapped) and empty rows. The model of K6 equals the
    plain merge, and so does the plain merge with the units in another
    order (the kernel's compaction order varies)."""
    r = np.random.default_rng(n_seg)
    B, C_ = 500, 6
    single = np.where(r.random((B, n_seg)) < 0.7,
                      r.integers(0, 20, (B, n_seg)), SIG_PAD).astype(np.int32)
    need = r.random((B, n_seg)) < 0.4
    single[need] = SIG_PAD
    nu = int(need.sum())
    slot = np.full((B, n_seg), -1, np.int32)
    slot[need] = np.arange(nu)
    sig_d = np.full((nu, C_), SIG_PAD, np.int32)
    mapped_d = np.zeros(nu, bool)
    for u in range(nu):
        n = int(r.integers(0, C_ + 3))
        vals = np.sort(r.choice(20, size=n, replace=False))
        sig_d[u, :min(n, C_)] = vals[:C_]
        mapped_d[u] = 0 < n <= C_
    args = [torch.from_numpy(a) for a in (single, slot, sig_d, mapped_d)]
    want = probe.merge_staging(*args, C_)
    got = merge_model(single, slot, sig_d, mapped_d, C_)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert want[1].any() and not want[1].all()
    perm = r.permutation(nu)  # unit u moves to row inv[u]
    inv = np.argsort(perm)
    slot2 = np.where(slot >= 0, inv[np.maximum(slot, 0)], -1).astype(np.int32)
    again = fast_cuda.merge_staging(
        *(torch.from_numpy(a) for a in (single, slot2, sig_d[perm],
                                        mapped_d[perm])), C_)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


@pytest.mark.parametrize("C_", [*range(1, 33), 40])
@pytest.mark.parametrize("n_seg", [1, 2])
def test_merge_model_every_width(n_seg, C_):
    """K6's two-way merge against ``merge_staging`` at C 1..32 and 40:
    full rows, lists that share values (values drawn from 2C or from C),
    empty lists, no unit and every segment a unit."""
    r = np.random.default_rng(1000 * n_seg + C_)
    for n_vals, share in ((2 * C_ + 1, 0.4), (C_ + 1, 0.8), (3, 1.0),
                          (2 * C_, 0.0)):
        single, slot, sig_d, mapped_d = _staging(r, 64, n_seg, C_, n_vals,
                                                 share)
        args = [torch.from_numpy(a) for a in (single, slot, sig_d, mapped_d)]
        want = probe.merge_staging(*args, C_)
        got = merge_model(single, slot, sig_d, mapped_d, C_)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


# ---- the CLI --------------------------------------------------------------


def test_cli_fast_mode_matches_jax_cli(world, tmp_path):
    """``infer --probe-sample 4`` of both CLIs on the same files: the same
    mapped and unmapped counts, est_counts within the pipeline bound of
    float32 EM in two summation orders, and ``probe_sample`` recorded."""
    index, r1, _ = world
    fq, idx = str(tmp_path / "r.fq"), str(tmp_path / "index.npz")
    write_fastq(fq, [r for r in r1 if len(r) > 64])  # one length bucket
    index.save(idx)
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        out = str(tmp_path / name)
        argv = ["infer", idx, out, fq, "--probe-sample", "4",
                "--sample-fallback", "0.25", "--batch-size", "128"]
        if name == "port":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        info = json.load(open(os.path.join(out, "run_info.json")))
        outs[name] = (info, read_abundance(os.path.join(out,
                                                        "abundance.tsv")))
    (ji, jt), (ti, tt) = outs["jax"], outs["port"]
    assert ti["probe_sample"] == ji["probe_sample"] == 4
    assert (ti["mapped"], ti["unmapped"]) == (ji["mapped"], ji["unmapped"])
    assert ti["kernel_launches"]["sample"] == 0  # the CPU takes no kernel
    np.testing.assert_allclose(tt["est_counts"], jt["est_counts"],
                               rtol=5e-3, atol=5e-2)
