"""K1's closed form, its out-and-offset form, and K2's hi-collision rules,
on the CPU against the JAX package.

- A numpy model of the pack kernel's window arithmetic (``csrc/pack.cu``:
  a quad of windows as shifts of the row's little-endian bits, bad bases
  cleared through their spread bitmask, the forward strand by one bit
  reversal a quad, the reverse complement by a complement) against JAX
  ``pack_canonical`` for every k from 1 to 29: it proves the derivation
  the kernel rests on.
- The port's pack writing two mates into one (B, 2P) output against the
  concatenation of separate calls and of JAX ``pack_canonical``.
- The port's plain lookup against JAX ``lookup_ecs_aux`` on synthetic
  buckets whose slots share a key's hi but not its lo.
All outputs are integers and must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seekmer_tpu.ops.kmer_pack import pack_canonical as j_pack
from seekmer_tpu.ops.probe import device_table_layout as j_layout
from seekmer_tpu.ops.probe import lookup_ecs_aux as j_lookup
from seekmer_tpu_torch import encoding as enc
from seekmer_tpu_torch.ops import pack_cuda, probe_cuda
from seekmer_tpu_torch.ops.probe import device_table_layout
from tests.synthetic_buckets import (check_expected, hi_collision_tables,
                                     query_lanes)

torch.set_num_threads(1)

U64 = np.uint64
PAIRS = U64(0x5555555555555555)
# bit i of a byte moved to bit 7 - i
_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(B, L, k, seed):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[r.random((B, L)) < 0.03] = 4  # N bases
    lengths = r.integers(max(k - 3, 1), L + 1, size=B).astype(np.int32)
    lengths[:3] = [L, k, k - 1]  # full, exactly one window, none
    for i, n in enumerate(lengths):
        codes[i, n:] = 4  # padding, as the batchers write it
    return codes, lengths


# ---------------------------------------------------------------- K1 model

def _le64(rows, start):
    """The little-endian 64-bit word of each row from byte ``start[p]``."""
    pad = np.zeros((rows.shape[0], rows.shape[1] + 8), np.uint8)
    pad[:, :rows.shape[1]] = rows
    b = pad[:, start[:, None] + np.arange(8)].astype(U64)  # (B, P, 8)
    return np.bitwise_or.reduce(b << (U64(8) * np.arange(8, dtype=U64)),
                                axis=-1)


def _spread2(x):
    """Bit i of x moves to bit 2i."""
    for s, m in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                 (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                 (1, 0x5555555555555555)):
        x = (x | (x << U64(s))) & U64(m)
    return x


def _brev64(x):
    """Reverse the 64 bits of each word."""
    b = np.ascontiguousarray(x.astype("<u8")).view(np.uint8)
    b = _REV8[b.reshape(x.shape + (8,))[..., ::-1]]
    return np.ascontiguousarray(b).view("<u8").reshape(x.shape)


def closed_form_pack(packed, bad, lengths, L, k):
    """Numpy model of the pack kernel, which takes windows in quads of 4:
    (hi, lo, valid) of every window."""
    P = L - k + 1
    p = np.arange(P)
    p0, q = p & ~3, (p & 3).astype(U64)  # the quad's first window, and q
    mask2k = U64((1 << 2 * k) - 1)
    # base j is bit 2j of the row read as little-endian words: W holds the
    # 32 bases from p0, and the quad's k + 3 bad bits cover its windows
    W = _le64(packed, p0 >> 2)
    nb = (_le64(bad, p0 >> 3) >> (p0 & 7).astype(U64)) & U64(
        (1 << k + 3) - 1)
    g = _spread2(nb)
    W &= ~(g | (g << U64(1)))  # bad bases pack as A
    rc = ~(W >> (U64(2) * q)) & mask2k  # base i complemented sits at 2i
    Bs = _brev64(((W >> U64(1)) & PAIRS) | ((W & PAIRS) << U64(1)))
    F = (Bs << (U64(2) * q)) >> U64(64 - 2 * k)  # base 0 in the top group
    canon = np.minimum(F, rc)
    lo_bits = U64(2 * (k - k // 2))
    hi = (canon >> lo_bits).astype(np.int32)
    lo = (canon & ((U64(1) << lo_bits) - U64(1))).astype(np.int32)
    valid = (p[None, :] + k <= lengths[:, None]) & (
        (nb >> q) & U64((1 << k) - 1) == 0)
    return hi, lo, valid


@pytest.mark.parametrize("L", [101, 128])
@pytest.mark.parametrize("k", range(1, 30))
def test_closed_form_pack_matches_jax(k, L):
    codes, lengths = _codes(24, L, k, seed=1000 * L + k)
    packed, bad = enc.pack_codes_2bit(codes)
    got = closed_form_pack(packed, bad, lengths, L, k)
    want = j_pack(jnp.asarray(codes), jnp.asarray(lengths), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[2].any() and not got[2].all()


# ---------------------------------------------------------------- K1 out form

@pytest.mark.parametrize("k,L", [(25, 101), (25, 128), (3, 37)])
def test_pack_out_and_offset_joins_mates(k, L):
    B, P = 40, L - k + 1
    mates = [_codes(B, L, k, seed=s) for s in (7, 8)]
    out = (torch.full((B, 2 * P), 99, dtype=torch.int32),
           torch.full((B, 2 * P), 99, dtype=torch.int32),
           torch.zeros((B, 2 * P), dtype=torch.bool))
    apart = []
    for i, (codes, lengths) in enumerate(mates):
        packed, bad = (_t(a) for a in enc.pack_codes_2bit(codes))
        assert pack_cuda.pack_canonical_2bit(
            packed, bad, _t(lengths), L, k, out=out, offset=i * P) is out
        apart.append(pack_cuda.pack_canonical_2bit(packed, bad, _t(lengths),
                                                   L, k))
    want = [np.concatenate([np.asarray(x) for x in parts], axis=1)
            for parts in zip(*(j_pack(jnp.asarray(c), jnp.asarray(n), k)
                               for c, n in mates))]
    for o, a, b, w in zip(out, *apart, want):
        assert torch.equal(o, torch.cat([a, b], dim=1))
        np.testing.assert_array_equal(o.numpy(), w)


def test_pack_out_must_hold_the_windows():
    codes, lengths = _codes(4, 40, 25, seed=3)
    packed, bad = (_t(a) for a in enc.pack_codes_2bit(codes))
    out = (torch.zeros((4, 20), dtype=torch.int32),
           torch.zeros((4, 20), dtype=torch.int32),
           torch.zeros((4, 20), dtype=torch.bool))
    with pytest.raises(ValueError, match="windows"):
        pack_cuda.pack_canonical_2bit(packed, bad, _t(lengths), 40, 25,
                                      out=out, offset=8)


# ---------------------------------------------------------------- K2 rules

@pytest.mark.parametrize("G", [4, 32])
def test_lookup_hi_collisions_match_jax(G):
    table, stash, queries = hi_collision_tables(G, seed=G)
    hi, lo, valid = query_lanes(queries)
    main_slots, stash_slots = table.shape[0], stash.shape[0]
    ec_j, aux_j = j_lookup(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        jnp.asarray(j_layout(table, G)), main_slots,
        jnp.asarray(j_layout(stash, G)), stash_slots, G)
    ec, aux = probe_cuda.lookup_ecs_aux(
        _t(hi), _t(lo), _t(valid), _t(device_table_layout(table, G)),
        main_slots, _t(device_table_layout(stash, G)), stash_slots, G)
    np.testing.assert_array_equal(ec.numpy(), np.asarray(ec_j))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(aux_j))
    check_expected(queries, ec.numpy(), aux.numpy())
