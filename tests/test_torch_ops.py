"""The port's plain ops (seekmer_tpu_torch.ops) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode, as the JAX package's own tests run it on
the CPU) and through the port's kernel wrapper, which takes its plain
PyTorch version for CPU tensors. All outputs here are integers and must be
equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seekmer_tpu import encoding as enc
from seekmer_tpu.config import IndexConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.ops import hash as jhash
from seekmer_tpu.ops.kmer_pack import unpack_codes_2bit as j_unpack
from seekmer_tpu.ops.pack_pallas import pack_canonical_pallas
from seekmer_tpu.ops.probe import device_table_layout as j_layout
from seekmer_tpu.ops.probe_pallas import lookup_ecs_aux_pallas
from seekmer_tpu.ops.sig_pallas import read_signatures_pallas
from seekmer_tpu.utils.simulate import (
    random_transcriptome,
    simulate_packed_batches,
)
from seekmer_tpu_torch.ops import hash as thash
from seekmer_tpu_torch.ops import pack_cuda, probe_cuda, sig_cuda
from seekmer_tpu_torch.ops.kmer_pack import unpack_codes_2bit
from seekmer_tpu_torch.ops.probe import device_table_layout

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- hashing

def _u32_keys(n=4096, seed=5):
    r = np.random.default_rng(seed)
    keys = r.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    keys[:6] = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 2, (1 << 32) - 1]
    assert (keys >= 1 << 31).any()
    return keys


@pytest.mark.parametrize("name", ["mix32", "hash_kmer", "hash_kmer_stash",
                                  "sig_slot_hash", "sig_fingerprint_step"])
def test_hash_bit_equal(name):
    a, b = _u32_keys(seed=1), _u32_keys(seed=2)
    ta = _t(a.view(np.int32))  # the port takes int32 lanes as uint32
    tb = _t(b.view(np.int32))
    if name == "mix32":
        want = [jhash.mix32(a)]
        got = [thash.mix32(thash.as_u32(ta))]
    elif name == "sig_fingerprint_step":
        h1, h2 = jhash.sig_fingerprint_init()
        want = jhash.sig_fingerprint_step(np.full_like(a, h1),
                                          np.full_like(a, h2), b)
        i1, i2 = thash.sig_fingerprint_init()
        got = thash.sig_fingerprint_step(torch.full((a.size,), i1),
                                         torch.full((a.size,), i2), tb)
    else:
        want = [getattr(jhash, name)(a, b)]
        got = [getattr(thash, name)(ta, tb)]
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


# ---------------------------------------------------------------- packing

def _codes(B, L, k, seed):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[r.random((B, L)) < 0.02] = 4  # N bases
    lengths = r.integers(max(k - 3, 1), L + 1, size=B).astype(np.int32)
    lengths[:3] = [L, k, k - 1]  # full, exactly one window, none
    for i, n in enumerate(lengths):
        codes[i, n:] = 4  # padding, as the batchers write it
    return codes, lengths


@pytest.mark.parametrize("k,L", [(25, 96), (29, 70), (21, 64)])
def test_pack_matches_pallas(k, L):
    codes, lengths = _codes(70, L, k, seed=k)
    hi_j, lo_j, v_j = pack_canonical_pallas(
        jnp.asarray(codes), jnp.asarray(lengths), k, block=32,
        interpret=True)
    packed, bad = enc.pack_codes_2bit(codes)
    hi, lo, v = pack_cuda.pack_canonical_2bit(_t(packed), _t(bad),
                                              _t(lengths), L, k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    assert v.numpy().any() and not v.numpy()[2].any()


def test_pack_matches_host_canonical_kmers():
    k = 5
    seq = "ACGTTTGCA" + "N" + "ACGTA"
    codes = enc.seq_to_codes(seq)[None, :]
    packed, bad = enc.pack_codes_2bit(codes)
    hi, lo, v = pack_cuda.pack_canonical_2bit(
        _t(packed), _t(bad), torch.tensor([len(seq)], dtype=torch.int32),
        len(seq), k)
    keys, valid = enc.canonical_kmers(enc.seq_to_codes(seq), k)
    np.testing.assert_array_equal(v.numpy()[0], valid)
    h_host, l_host = enc.split_key(keys, k)
    np.testing.assert_array_equal(hi.numpy()[0][valid], h_host[valid])
    np.testing.assert_array_equal(lo.numpy()[0][valid], l_host[valid])


@pytest.mark.parametrize("L", [96, 101])
def test_unpack_matches_jax(L):
    codes, _ = _codes(33, L, 25, seed=L)
    packed, bad = enc.pack_codes_2bit(codes)
    want = np.asarray(j_unpack(jnp.asarray(packed), jnp.asarray(bad), L))
    got = unpack_codes_2bit(_t(packed), _t(bad), L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.minimum(codes, 4))


# ---------------------------------------------------------------- lookup

@pytest.fixture(scope="module")
def worlds():
    """A default index and one with 4-slot buckets, whose full buckets put
    keys in the stash."""
    rng = np.random.default_rng(77)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=120, max_len=400,
        shared_prefix_frac=0.5)
    return rng, seqs, {
        "default": build_index_from_seqs(names, seqs),
        "stash": build_index_from_seqs(names, seqs,
                                       cfg=IndexConfig(bucket_size=4)),
    }


def _lookup_both(index, hi, lo, valid, m=1):
    jt = jnp.asarray(j_layout(index.table, index.bucket))
    js = jnp.asarray(j_layout(index.stash, index.bucket))
    ec_j, aux_j = lookup_ecs_aux_pallas(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), jt,
        index.main_slots, js, index.stash_slots, index.bucket, m=m,
        interpret=True)
    tt = _t(device_table_layout(index.table, index.bucket))
    ts = _t(device_table_layout(index.stash, index.bucket))
    ec, aux = probe_cuda.lookup_ecs_aux(
        _t(hi), _t(lo), _t(valid), tt, index.main_slots, ts,
        index.stash_slots, index.bucket)
    np.testing.assert_array_equal(ec.numpy(), np.asarray(ec_j))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(aux_j))
    return ec.numpy(), aux.numpy()


def test_layout_matches_jax(worlds):
    _, _, idx = worlds
    for index in idx.values():
        np.testing.assert_array_equal(
            device_table_layout(index.stash, index.bucket),
            j_layout(index.stash, index.bucket))


@pytest.mark.parametrize("which", ["default", "stash"])
def test_lookup_reads_match_pallas(worlds, which):
    rng, seqs, idx = worlds
    index = idx[which]
    B, L = 32, 100
    codes, _ = simulate_packed_batches(rng, seqs, 1, B, read_len=L,
                                       error_rate=0.02)
    packed, bad = enc.pack_codes_2bit(codes[0])
    hi, lo, v = pack_cuda.pack_canonical_2bit(
        _t(packed), _t(bad), torch.full((B,), L, dtype=torch.int32), L,
        index.k)
    ec, _ = _lookup_both(index, hi.numpy(), lo.numpy(), v.numpy(), m=2)
    assert (ec >= 0).any()


def test_lookup_absent_and_invalid_lanes(worlds):
    rng, _, idx = worlds
    N = 300
    hi = rng.integers(0, 1 << 30, N, dtype=np.int32)
    lo = rng.integers(0, 1 << 20, N, dtype=np.int32)
    valid = rng.random(N) < 0.7
    ec, aux = _lookup_both(idx["default"], hi, lo, valid)
    assert (ec == -1).all() and (aux == 0).all()


@pytest.mark.parametrize("table", ["table", "stash"])
def test_lookup_every_indexed_key(worlds, table):
    """Every key of the 4-slot index, main-table and stash-resident, is
    found with its stored EC and run length; invalid copies miss."""
    _, _, idx = worlds
    index = idx["stash"]
    rows = np.asarray(getattr(index, table))
    occ = np.flatnonzero(rows[:, 0] != -1)[:1024]
    assert occ.size > 0
    valid = np.ones(occ.size, bool)
    valid[::7] = False
    ec, aux = _lookup_both(index, rows[occ, 0], rows[occ, 1], valid)
    np.testing.assert_array_equal(ec[valid], rows[occ, 2][valid])
    np.testing.assert_array_equal(aux[valid], np.minimum(rows[occ, 3],
                                                         127)[valid])
    assert (ec[~valid] == -1).all()


def test_synthetic_stash_hit():
    """A key whose main home bucket is full and that lives only in the
    stash resolves; an absent key misses."""
    bucket, nb, nb_s = 4, 8, 4
    main = np.full((nb * bucket, 4), -1, np.int32)
    stash = np.full((nb_s * bucket, 4), -1, np.int32)
    key = (np.int32(12345), np.int32(678))
    hb = int(jhash.hash_kmer(np.uint32(key[0]), np.uint32(key[1])) & (nb - 1))
    for s in range(bucket):
        main[hb * bucket + s] = (1000 + s, 2000 + s, 7 + s, 0)
    sb = int(jhash.hash_kmer_stash(np.uint32(key[0]), np.uint32(key[1]))
             & (nb_s - 1))
    stash[sb * bucket + 1] = (key[0], key[1], 42, 3)

    class Tables:
        pass

    t = Tables()
    t.table, t.stash, t.bucket = main, stash, bucket
    t.main_slots, t.stash_slots = nb * bucket, nb_s * bucket
    ec, aux = _lookup_both(t, np.array([key[0], 999999], np.int32),
                           np.array([key[1], 999999], np.int32),
                           np.ones(2, bool))
    assert ec.tolist() == [42, -1] and aux.tolist() == [3, 0]


# ---------------------------------------------------------------- signatures

def _sig_both(ecs, valid, C, block=8):
    sig_j, map_j = read_signatures_pallas(jnp.asarray(ecs),
                                          jnp.asarray(valid), C, block=block,
                                          interpret=True)
    sig, mapped = sig_cuda.read_signatures(_t(ecs), _t(valid), C)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_j))
    np.testing.assert_array_equal(mapped.numpy(), np.asarray(map_j))
    return sig.numpy(), mapped.numpy()


def test_signatures_random_lanes():
    r = np.random.default_rng(3)
    ecs = r.integers(-1, 40, size=(24, 76)).astype(np.int32)
    _sig_both(ecs, r.random((24, 76)) < 0.8, 8)


def test_signatures_no_hits_and_complex_reads():
    r = np.random.default_rng(4)
    B, P, C = 16, 50, 4
    ecs = r.integers(0, 1000, size=(B, P)).astype(np.int32)
    ecs[0] = -1
    ecs[1] = 7
    valid = np.ones((B, P), bool)
    valid[2] = False
    sig, mapped = _sig_both(ecs, valid, C)
    assert not mapped[0] and not mapped[2] and not mapped[3]
    assert mapped[1] and sig[1, 0] == 7


def test_signatures_exactly_c_distinct():
    ecs = np.tile(np.arange(5, dtype=np.int32), (4, 6))
    sig, mapped = _sig_both(ecs, np.ones(ecs.shape, bool), 5)
    assert mapped.all()
    np.testing.assert_array_equal(sig[0], np.arange(5))


@pytest.mark.parametrize("P", [200, 600])
def test_signatures_wide_window_axis(P):
    """P = 600 is a paired row of two 300-window mates: a 1024 network."""
    r = np.random.default_rng(P)
    ecs = r.integers(-1, 25, size=(8, P)).astype(np.int32)
    _sig_both(ecs, r.random((8, P)) < 0.9, 16)


def test_signatures_fewer_windows_than_c():
    r = np.random.default_rng(9)
    ecs = r.integers(-1, 5, size=(6, 3)).astype(np.int32)
    sig, _ = _sig_both(ecs, np.ones((6, 3), bool), 8)
    assert sig.shape == (6, 8)
