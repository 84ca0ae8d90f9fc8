"""The port's bootstrap (``seekmer_tpu_torch.em.bootstrap``) against the JAX
package: batched CSR EM on one shared count matrix, the route
``run_bootstrap`` takes, and the resampler by its moments (the JAX
multinomial bits cannot be reproduced)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig
from seekmer_tpu.em import bootstrap as jbs
from seekmer_tpu.em import em as jem
from seekmer_tpu_torch.config import EMConfig as TEMConfig
from seekmer_tpu_torch.em import bootstrap as tbs
from seekmer_tpu_torch.em import em as tem
from seekmer_tpu_torch.ops import em_cuda
from tests.test_torch_em_dense import _system, group_sums
from tests.test_torch_self_contained import port_config

torch.set_num_threads(1)


def _cmat(counts, B, seed):
    """B count rows around ``counts``, made with numpy for both packages."""
    rng = np.random.default_rng(seed)
    N = int(counts.sum())
    return np.stack([rng.multinomial(N, counts / counts.sum())
                     for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("accel", ["none", "squarem"])
def test_batched_em_matches_jax(accel):
    """Same cmat into both batched CSR EMs (float32): iteration counts
    within one block and group masses within the pipeline bound."""
    members, counts, lengths = _system(seed=21, T=50, E=120)
    T, B = lengths.size, 6
    cmat = _cmat(counts, B, seed=22)
    cfg = EMConfig(rel_tol=1e-6, max_iters=3000, accel=accel)
    jec = jem.build_ec_table(members, counts, T)
    j_alpha, j_it = jbs.batched_em(jnp.asarray(cmat), jnp.float32,
                                   jec.ec_ids, jec.txp_ids,
                                   jnp.asarray(lengths), jec.num_ecs, T, cfg)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    alpha, it = tbs.batched_em(torch.from_numpy(cmat), ec.ec_ids,
                               ec.txp_ids, lengths, ec.num_ecs, T,
                               port_config(cfg))
    assert alpha.shape == (B, T) and alpha.dtype == torch.float32
    assert abs(it - int(j_it)) <= cfg.check_every, (it, int(j_it))
    np.testing.assert_allclose(group_sums(alpha.numpy(), members, T),
                               group_sums(np.asarray(j_alpha), members, T),
                               rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(alpha.sum(dim=1).numpy(), cmat.sum(axis=1),
                               rtol=1e-4)


def _spy(monkeypatch):
    calls = []
    real = em_cuda.em_fixed_point

    def spy(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(em_cuda, "em_fixed_point", spy)
    return calls


@pytest.mark.parametrize("case", [
    ("small", dict(), 8),
    ("small", dict(backend="csr"), 8),
    ("small", dict(backend="pallas"), 8),
    ("small", dict(use_x64=True), 8),
    ("small", dict(accel="squarem"), 1),
    ("large", dict(), 4),
], ids=["auto", "csr", "pallas", "x64", "auto_R1", "auto_too_large"])
def test_run_bootstrap_route_matches_jax(monkeypatch, case):
    """run_bootstrap takes the dense route exactly when JAX's _use_pallas
    says so for the same system; each replicate's mass equals N."""
    size, over, B = case
    if size == "small":
        members, counts, lengths = _system(seed=23)
    else:  # over the dense gate: 1500 x 3000 membership
        members, counts, lengths = _system(seed=24, T=3000, E=1500)
    T = lengths.size
    cfg = dataclasses.replace(EMConfig(rel_tol=1e-5, max_iters=400,
                                       bootstrap_samples=B,
                                       bootstrap_seed=5), **over)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    want = jem._use_pallas(jem.build_ec_table(members, counts, T), cfg,
                           replicates=B)
    tcfg = port_config(cfg)
    assert tem.use_dense(ec, tcfg, replicates=B) == want
    calls = _spy(monkeypatch)
    boot, it = tbs.run_bootstrap(ec, lengths, tcfg)
    assert calls == ([(B, ec.num_ecs)] if want else [])
    assert boot.shape == (B, T) and boot.dtype == torch.float32
    assert 0 < it <= cfg.max_iters
    N = counts.sum()
    np.testing.assert_allclose(boot.sum(dim=1).numpy(), N, rtol=1e-4)


def test_run_bootstrap_seeded():
    """The same seed gives the same replicates; another seed others."""
    members, counts, lengths = _system(seed=25)
    T = lengths.size
    cfg = TEMConfig(rel_tol=1e-5, bootstrap_samples=4, bootstrap_seed=7)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    a, _ = tbs.run_bootstrap(ec, lengths, cfg)
    b, _ = tbs.run_bootstrap(ec, lengths, cfg)
    c, _ = tbs.run_bootstrap(ec, lengths,
                             dataclasses.replace(cfg, bootstrap_seed=8))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a[0], a[1])  # replicates differ


def test_resampler_moments():
    """Over many replicates each EC's mean count is N p within 4 standard
    errors, every replicate sums to N, and the draws are integers."""
    rng = np.random.default_rng(26)
    counts = rng.integers(0, 300, size=20).astype(np.float32)
    counts[3] = 0.0
    N = int(counts.sum())
    B = 1000
    g = torch.Generator().manual_seed(3)
    cmat = tbs.resample_counts(torch.from_numpy(counts), B, g).numpy()
    assert cmat.shape == (B, counts.size) and cmat.dtype == np.float32
    np.testing.assert_array_equal(cmat.sum(axis=1), N)
    np.testing.assert_array_equal(cmat, np.round(cmat))
    assert (cmat[:, 3] == 0).all()
    p = counts / N
    se = np.sqrt(N * p * (1 - p) / B)
    dev = np.abs(cmat.mean(axis=0) - N * p)
    assert (dev <= 4 * se + 1e-9).all(), (dev / np.maximum(se, 1e-12)).max()
    # and the spread per EC is the multinomial's, within 20%
    sd = cmat.std(axis=0)
    live = p > 0.02
    np.testing.assert_allclose(sd[live], np.sqrt(N * p * (1 - p))[live],
                               rtol=0.2)
