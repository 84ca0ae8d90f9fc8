"""The port's dense EM fixed point (the plain version of K4,
``seekmer_tpu_torch.ops.em_dense``) against the JAX Pallas kernel run in
interpret mode and the float64 oracle, the dense gate, and ``run_em``'s
routing under ``EMConfig.backend``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig
from seekmer_tpu.em import em as jem
from seekmer_tpu.ops import em_pallas
from seekmer_tpu_torch.em import em as tem
from seekmer_tpu_torch.ops import em_cuda, em_dense
from tests.oracle import oracle

torch.set_num_threads(1)


def _system(seed, T=60, E=150):
    """The system of tests/test_em_pallas.py."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 6)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 500, size=E).astype(np.float64)
    return members, counts, lengths


def _dense(members, T):
    M = np.zeros((len(members), T), np.float32)
    for e, m in enumerate(members):
        M[e, m] = 1.0
    return M


def group_sums(alpha, members, T):
    """Mass of each group of transcripts with identical EC membership
    (columns [B, G]): such transcripts are EM-degenerate, so only their
    summed mass is determined (tests/test_em_pallas.py)."""
    sig = [tuple() for _ in range(T)]
    for e, m in enumerate(members):
        for t in m:
            sig[t] = sig[t] + (e,)
    groups = {}
    for t, s in enumerate(sig):
        groups.setdefault(s, []).append(t)
    a = np.atleast_2d(alpha)
    return np.stack([a[:, ts].sum(axis=1) for ts in groups.values()], 1)


@pytest.mark.parametrize("R", [1, 8])
def test_dense_em_matches_jax_kernel(R):
    """The plain dense fixed point against the JAX kernel (interpret mode)
    on the same float32 inputs: iteration counts within one check_every
    block; group masses within rtol 5e-3, atol 5e-2 (float32 sums in
    another order, and a borderline block may end one block apart)."""
    members, counts, lengths = _system(seed=11)
    T = lengths.size
    rng = np.random.default_rng(12)
    n = (counts[None, :] * rng.uniform(0.5, 1.5, size=(R, counts.size))
         ).astype(np.float32)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    eff = oracle.effective_lengths(lengths, cfg).astype(np.float32)
    inv_eff = (1.0 / eff)[None, :].astype(np.float32)
    alpha0 = np.repeat(n.sum(axis=1, keepdims=True) / T, T, axis=1).astype(
        np.float32)
    M = _dense(members, T)

    j_alpha, j_it = em_pallas.em_fixed_point(
        jnp.asarray(M), jnp.asarray(n), jnp.asarray(inv_eff),
        jnp.asarray(alpha0), cfg, T, interpret=True)
    alpha, it = em_dense.em_fixed_point(
        torch.from_numpy(M), torch.from_numpy(n), torch.from_numpy(inv_eff),
        torch.from_numpy(alpha0), cfg)
    assert alpha.dtype == torch.float32 and alpha.shape == (R, T)
    assert abs(it - int(j_it)) <= cfg.check_every
    np.testing.assert_allclose(group_sums(alpha.numpy(), members, T),
                               group_sums(np.asarray(j_alpha), members, T),
                               rtol=5e-3, atol=5e-2)
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch
    before = em_cuda.em_fixed_point.launches
    alpha_w, it_w = em_cuda.em_fixed_point(
        torch.from_numpy(M), torch.from_numpy(n), torch.from_numpy(inv_eff),
        torch.from_numpy(alpha0), cfg)
    assert em_cuda.em_fixed_point.launches == before
    assert it_w == it and torch.equal(alpha_w, alpha)


@pytest.mark.parametrize("sd", [0.0, 30.0])
def test_dense_em_x64_matches_oracle(sd):
    """float64 throughout: the same blocked schedule gives the oracle's
    iteration count, and est_counts agree to 1e-9 relative."""
    members, counts, lengths = _system(seed=13)
    T = lengths.size
    cfg = EMConfig(rel_tol=1e-8, max_iters=5000, use_x64=True,
                   fragment_length_sd=sd)
    o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
    eff = oracle.effective_lengths(lengths, cfg)
    alpha, it = em_dense.em_fixed_point(
        torch.from_numpy(_dense(members, T).astype(np.float64)),
        torch.from_numpy(counts[None, :]),
        torch.from_numpy(1.0 / eff),
        torch.full((1, T), counts.sum() / T, dtype=torch.float64), cfg)
    assert it == o_it
    np.testing.assert_allclose(alpha[0].numpy(), o_alpha, rtol=1e-9,
                               atol=1e-9)


def test_fits_dense_equals_fits_pallas():
    grid = [(E, T, R) for E in (1, 100, 1000, 1396, 1408, 1409, 3000, 20000)
            for T in (1, 500, 1000, 1024, 1025, 2048, 57273)
            for R in (1, 8, 9, 100, 104, 105, 1000)]
    got = [em_dense.fits_dense(*g) for g in grid]
    assert got == [em_pallas.fits_pallas(*g) for g in grid]
    assert any(got) and not all(got)
    assert em_dense.fits_dense(1396, 1000, 100)  # config-1 bootstrap


def test_run_em_pallas_backend_matches_jax():
    """backend="pallas" routes a fresh single run through the dense fixed
    point in both packages; the results agree as the kernels do."""
    members, counts, lengths = _system(seed=14)
    T = lengths.size
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000, backend="pallas")
    ec = tem.build_ec_table(members, counts, T)
    assert tem.use_dense(ec, cfg)
    assert not tem.use_dense(ec, dataclasses.replace(cfg, backend="auto"))
    alpha, it = tem.run_em(ec, lengths, cfg)
    j_alpha, j_it = jem.run_em(jem.build_ec_table(members, counts, T),
                               lengths, cfg)
    assert alpha.dtype == torch.float32 and alpha.shape == (T,)
    assert abs(it - int(j_it)) <= cfg.check_every
    np.testing.assert_allclose(group_sums(alpha.numpy(), members, T),
                               group_sums(np.asarray(j_alpha), members, T),
                               rtol=5e-3, atol=5e-2)
    o_alpha, _ = oracle.run_em(members, counts, lengths, cfg)
    np.testing.assert_allclose(group_sums(alpha.numpy(), members, T),
                               group_sums(o_alpha, members, T),
                               rtol=5e-3, atol=5e-2)


def test_run_em_pallas_backend_resume_stays_on_csr():
    """A resumed run (it_init > 0) keeps the CSR form, whose budget counts
    total iterations, under backend="pallas" too."""
    members, counts, lengths = _system(seed=15)
    T = lengths.size
    cfg = EMConfig(rel_tol=0.0, max_iters=64, backend="pallas")
    ec = tem.build_ec_table(members, counts, T)
    a32, _ = tem.run_em(ec, lengths, dataclasses.replace(
        cfg, max_iters=32, backend="csr"))
    _, it = tem.run_em(ec, lengths, cfg, alpha_init=a32.numpy(), it_init=32)
    assert it == 64


def test_run_em_pallas_backend_too_large_raises():
    """A system over the gate raises ValueError under backend="pallas" in
    both packages, and stays on CSR under "auto" and "csr"."""
    T, E = 3000, 3000
    members = [np.array([e % T], np.int32) for e in range(E)]
    counts = np.ones(E)
    lengths = np.full(T, 1000, np.int32)
    cfg = EMConfig(backend="pallas", max_iters=16)
    assert not em_dense.fits_dense(E, T)
    with pytest.raises(ValueError, match="too large"):
        tem.run_em(tem.build_ec_table(members, counts, T), lengths, cfg)
    with pytest.raises(ValueError, match="too large"):
        jem.run_em(jem.build_ec_table(members, counts, T), lengths, cfg)
    ec = tem.build_ec_table(members, counts, T)
    for backend in ("auto", "csr"):
        assert not tem.use_dense(ec, dataclasses.replace(cfg,
                                                         backend=backend),
                                 replicates=8)
