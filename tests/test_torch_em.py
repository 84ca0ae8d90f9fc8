"""The port's EM (seekmer_tpu_torch.em.em) against the float64 oracle and
the JAX package's EM."""

import numpy as np
import pytest
import torch

from seekmer_tpu.config import EMConfig
from seekmer_tpu.em import em as jem
from seekmer_tpu_torch.config import EMConfig as TEMConfig
from seekmer_tpu_torch.em import em as tem
from tests.test_torch_self_contained import port_config, port_index
from tests.oracle import oracle

torch.set_num_threads(1)


def _system(seed, T=50, E=120):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 6)),
                                  replace=False)).astype(np.int32)
               for _ in range(E)]
    counts = rng.integers(1, 500, size=E).astype(np.float64)
    return members, counts, lengths


@pytest.mark.parametrize("accel", ["none", "squarem"])
@pytest.mark.parametrize("sd", [0.0, 30.0])
def test_em_x64_matches_oracle(accel, sd):
    """float64 on both sides: the same blocked schedule gives the same
    iteration count, and est_counts agree to 1e-9 relative (only the
    summation order differs)."""
    members, counts, lengths = _system(seed=7)
    cfg = EMConfig(rel_tol=1e-8, max_iters=5000, use_x64=True, accel=accel,
                   fragment_length_sd=sd)
    o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
    ec = tem.build_ec_table(members, counts, lengths.size,
                            dtype=torch.float64, device="cpu")
    tcfg = port_config(cfg)
    alpha, it = tem.run_em(ec, lengths, tcfg)
    assert it == o_it
    np.testing.assert_allclose(alpha.numpy(), o_alpha, rtol=1e-9, atol=1e-9)
    eff = tem.effective_lengths(lengths, tcfg, torch.float64, "cpu")
    np.testing.assert_allclose(eff.numpy(), oracle.effective_lengths(
        lengths, cfg), rtol=1e-12)
    ll = float(tem.log_likelihood(ec, alpha, eff))
    o_ll = oracle.log_likelihood(members, counts, o_alpha, eff.numpy())
    assert ll == pytest.approx(o_ll, rel=1e-9)
    tpm = tem.tpm_from_alpha(alpha, lengths, tcfg).numpy()
    # absolute floor: SQUAREM leaves some transcripts at ~1e-12, where the
    # summation order decides every digit
    np.testing.assert_allclose(tpm, oracle.tpm_from_alpha(o_alpha, lengths,
                                                          cfg),
                               rtol=1e-8, atol=1e-6)


def test_em_f32_within_twice_the_jax_error():
    """float32: the port's TPM error against the float64 oracle is no
    larger than twice the JAX float32 error measured here on the same
    system (both run the same schedule; the factor absorbs rounding in a
    different summation order)."""
    members, counts, lengths = _system(seed=8, T=80, E=200)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    o_alpha, o_it = oracle.run_em(members, counts, lengths, cfg)
    o_tpm = oracle.tpm_from_alpha(o_alpha, lengths, cfg)

    jec = jem.build_ec_table(members, counts, lengths.size)
    j_alpha, j_it = jem.run_em(jec, lengths, cfg)
    j_err = np.abs(np.asarray(jem.tpm_from_alpha(j_alpha, lengths, cfg))
                   - o_tpm).max()
    ec = tem.build_ec_table(members, counts, lengths.size, device="cpu")
    tcfg = port_config(cfg)
    alpha, it = tem.run_em(ec, lengths, tcfg)
    assert alpha.dtype == torch.float32
    err = np.abs(tem.tpm_from_alpha(alpha, lengths, tcfg).numpy()
                 - o_tpm).max()
    assert it == int(j_it)
    assert err <= 2 * j_err, (err, j_err)


def test_em_warm_start_counts_total_iterations():
    members, counts, lengths = _system(seed=9)
    cfg = TEMConfig(rel_tol=1e-8, max_iters=64, min_iters=0, use_x64=True)
    ec = tem.build_ec_table(members, counts, lengths.size,
                            dtype=torch.float64, device="cpu")
    a32, it32 = tem.run_em(ec, lengths,
                           TEMConfig(rel_tol=0.0, max_iters=32,
                                     use_x64=True))
    alpha, it = tem.run_em(ec, lengths, cfg, alpha_init=a32.numpy(),
                           it_init=it32)
    full, it_full = tem.run_em(ec, lengths, cfg)
    assert (it32, it, it_full) == (32, 64, 64)
    np.testing.assert_allclose(alpha.numpy(), full.numpy(), rtol=1e-12)


def _tree_sum(x):
    """numpy: the pairwise tree of ``em.ordered_sum``, element i with
    element i + half, x padded with zeros to a power of two."""
    n = x.size
    if n <= 1:
        return x.sum(dtype=x.dtype)
    x = np.concatenate([x, np.zeros((1 << (n - 1).bit_length()) - n,
                                    x.dtype)])
    while x.size > 1:
        x = x[:x.size // 2] + x[x.size // 2:]
    return x[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_log_likelihood_sums_in_one_fixed_order(dtype):
    """log_likelihood sums each EC's terms in nnz order from 0 and reduces
    alpha and the EC terms by one pairwise tree: its bits equal a numpy
    derivation in that order, on a table with empty ECs, an EC of 40
    members, zero counts and zero alpha; the tree itself equals numpy's
    for every length 0-40."""
    rng = np.random.default_rng(3)
    T = 60
    members = [np.sort(rng.choice(T, size=int(rng.integers(1, 6)),
                                  replace=False)).astype(np.int32)
               for _ in range(150)]
    members[4] = members[4][:0]
    members[9] = np.arange(40, dtype=np.int32)
    counts = rng.integers(0, 300, size=len(members)).astype(np.float64)
    counts[::7] = 0
    alpha = (rng.random(T) * 100).astype(dtype)
    alpha[::5] = 0
    eff = (rng.integers(250, 3000, size=T) - 180.0).astype(dtype)
    tdt = torch.from_numpy(alpha).dtype
    ec = tem.build_ec_table(members, counts, T, dtype=tdt, device="cpu")
    got = tem.log_likelihood(ec, torch.from_numpy(alpha),
                             torch.from_numpy(eff))
    assert got.dtype == tdt and got.device.type == "cpu"

    theta = alpha / max(_tree_sum(alpha), dtype(1e-300))
    denom = np.zeros(len(members), dtype)
    for c, m in enumerate(members):
        for t in m:  # nnz order, from 0
            denom[c] = denom[c] + theta[t] / eff[t]
    n = counts.astype(dtype)
    logs = torch.log(torch.from_numpy(np.maximum(denom, dtype(1e-300)))
                     ).numpy()
    want = _tree_sum(np.where((n > 0) & (denom > 0), n * logs, 0).astype(
        dtype))
    assert np.array_equal(np.array(float(got), dtype), np.array(want))
    for n_ in range(41):
        x = rng.random(n_).astype(dtype)
        assert np.array_equal(
            tem.ordered_sum(torch.from_numpy(x)).numpy(), _tree_sum(x))
