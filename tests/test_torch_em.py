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
