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
  window from the row's bytes, the any-valid-window scan) and K6
  (``csrc/merge.cu``: the two-way merge) against the plain versions; the kernels themselves are held to the plain versions on the
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


def sampled_window_model(packed, bad, lengths, L_, k, cols):
    """K5's window of each sampled column, as ``csrc/sample.cu`` computes
    it: the 8 bytes of the row from byte c / 4 (zeros past the row) shifted
    by 2 (c % 4) bases, the 5 bitmask bytes from byte c / 8 shifted by c %
    8, then ``kmer.cuh``'s closed form at q = 0 without clearing bad bases
    (a window with one is invalid and never looked up). Returns (hi, lo,
    valid) of shape (B, len(cols))."""
    def le(rows, start, n):
        pad = np.zeros((rows.shape[0], rows.shape[1] + n), np.uint8)
        pad[:, :rows.shape[1]] = rows
        b = pad[:, start[:, None] + np.arange(n)].astype(U64)
        return np.bitwise_or.reduce(
            b << (U64(8) * np.arange(n, dtype=U64)), axis=-1)

    c = np.asarray(cols)
    W = le(packed, c >> 2, 8) >> (U64(2) * (c & 3).astype(U64))
    nb = (le(bad, c >> 3, 5) >> (c & 7).astype(U64)) & U64((1 << k) - 1)
    R = ~W & U64((1 << 2 * k) - 1)
    F = _brev64(((W >> U64(1)) & PAIRS) | ((W & PAIRS) << U64(1))) >> U64(
        64 - 2 * k)
    canon = np.minimum(F, R)
    lo_bits = U64(2 * (k - k // 2))
    valid = (c[None, :] + k <= np.minimum(lengths, L_)[:, None]) & (nb == 0)
    return ((canon >> lo_bits).astype(np.int32),
            (canon & ((U64(1) << lo_bits) - U64(1))).astype(np.int32), valid)


def has_valid_window_model(bad_row, length, k):
    """K5's scan for k consecutive good bases within the length."""
    run = 0
    for i in range(length):
        if (int(bad_row[i >> 3]) >> (i & 7)) & 1:
            run = 0
        else:
            run += 1
            if run >= k:
                return True
    return False


@pytest.mark.parametrize("k", range(1, 30))
def test_sampled_window_model_matches_jax(k):
    """The model of K5's window arithmetic against the port's plain
    ``pack_canonical`` (held to JAX's in ``test_torch_pack_lookup.py``) at
    the sampled columns, on rows not a multiple of 4 or 8 bases long, so
    the last loads run past the row; and its valid-window scan against the
    plain valid windows."""
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
    for stride in (2, 16):
        cols = probe.sample_columns(P, stride)
        mh, ml, mv = sampled_window_model(packed, bad, lengths, L_, k, cols)
        np.testing.assert_array_equal(mv, valid[:, cols])
        np.testing.assert_array_equal(mh[mv], hi[:, cols][mv])
        np.testing.assert_array_equal(ml[mv], lo[:, cols][mv])
    scan = [has_valid_window_model(bad[i], min(int(lengths[i]), L_), k)
            for i in range(40)]
    np.testing.assert_array_equal(scan, valid.any(axis=1))


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
