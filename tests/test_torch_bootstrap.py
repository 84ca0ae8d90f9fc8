"""The port's bootstrap (``seekmer_tpu_torch.em.bootstrap``) against the JAX
package: batched CSR EM on one shared count matrix (iteration counts too,
on a mapped world), the route ``run_bootstrap`` takes, and the resampler
by its moments (the JAX multinomial bits cannot be reproduced).

``python -m tests.test_torch_bootstrap EC.npz`` compares both packages'
iteration counts on a larger EC table (:func:`main`)."""

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


def _mapped_world():
    """The EC table (members, counts) and lengths of a small isoform world
    mapped by the port: the structure of config 2's table, whose bootstrap
    runs to the 10,000-iteration cap on the card."""
    from seekmer_tpu_torch.index.build import build_index_from_seqs
    from seekmer_tpu_torch.io.fastq import ReadBatch
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.simulate import (isoform_transcriptome,
                                                  simulate_packed_pairs)

    rng = np.random.default_rng(27)
    names, seqs, genes = isoform_transcriptome(rng, num_genes=40)
    index = build_index_from_seqs(names, seqs, genes=genes)
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 2, 2048, read_len=100,
                                      mean_frag=200.0, sd_frag=20.0)
    ln = np.full(2048, 100, np.int32)
    result = Mapper(index, device="cpu").run(
        ReadBatch(c1[i], ln, np.ones(2048, np.int32), codes2=c2[i],
                  lengths2=ln) for i in range(2))
    members, counts, _ = resolve_signatures(result, index)
    return members, counts, index.lengths


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
def test_batched_em_iterations_match_jax_on_a_mapped_world(x64):
    """One numpy count matrix of a mapped isoform world's EC table into
    both packages' batched CSR EM at the ``infer`` defaults (rel_tol 1e-4,
    max_iters 10,000): the same iteration count at float64, within one
    check_every block at float32 (another summation order)."""
    import jax

    members, counts, lengths = _mapped_world()
    T, B = lengths.size, 4
    cmat = _cmat(counts, B, seed=28)
    cfg = EMConfig()
    jax.config.update("jax_enable_x64", x64)
    try:
        jdt = jnp.float64 if x64 else jnp.float32
        jec = jem.build_ec_table(members, counts, T, dtype=jdt)
        _, j_it = jbs.batched_em(jnp.asarray(cmat, jdt), jdt, jec.ec_ids,
                                 jec.txp_ids, jnp.asarray(lengths),
                                 jec.num_ecs, T, cfg)
        j_it = int(j_it)
    finally:
        jax.config.update("jax_enable_x64", False)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    tdt = torch.float64 if x64 else torch.float32
    alpha, it = tbs.batched_em(torch.from_numpy(cmat).to(tdt), ec.ec_ids,
                               ec.txp_ids, lengths, ec.num_ecs, T,
                               port_config(cfg))
    assert alpha.dtype == tdt
    assert 0 < j_it <= cfg.max_iters
    if x64:
        assert it == j_it, (it, j_it)
    else:
        assert abs(it - j_it) <= cfg.check_every, (it, j_it)


def main(argv=None) -> int:
    """Both packages' batched CSR EM on one EC table, iteration counts side
    by side (``python -m tests.test_torch_bootstrap EC.npz``): EC.npz is
    what ``chip_smoke.py --keep-inputs PATH`` writes to PATH.c2_ec.npz
    (counts, lengths, sizes, members). One numpy count matrix (multinomial
    resamples of the counts, seed 0) goes to both at the ``infer``
    defaults (rel_tol 1e-4, max_iters 10,000), float32 unless ``--x64``.
    Runs on the CPU."""
    import argparse
    import time

    ap = argparse.ArgumentParser(
        description="both packages' batched CSR EM iteration counts")
    ap.add_argument("ec")
    ap.add_argument("--replicates", type=int, default=4)
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", args.x64)

    d = np.load(args.ec)
    counts, lengths = d["counts"], d["lengths"]
    members = np.split(d["members"], np.cumsum(d["sizes"])[:-1])
    T = lengths.size
    rng = np.random.default_rng(0)
    N = int(round(counts.sum()))
    cmat = np.stack([rng.multinomial(N, counts / counts.sum())
                     for _ in range(args.replicates)]).astype(np.float32)
    jdt = jnp.float64 if args.x64 else jnp.float32
    tdt = torch.float64 if args.x64 else torch.float32
    print(f"{len(members)} ECs, nnz {d['members'].size}, T {T}, "
          f"{args.replicates} replicates, {tdt}")

    t0 = time.perf_counter()
    jec = jem.build_ec_table(members, counts, T, dtype=jdt)
    _, j_it = jbs.batched_em(jnp.asarray(cmat, jdt), jdt, jec.ec_ids,
                             jec.txp_ids, jnp.asarray(lengths), jec.num_ecs,
                             T, EMConfig())
    print(f"JAX batched_em: {int(j_it)} iterations "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    _, it = tbs.batched_em(torch.from_numpy(cmat).to(tdt), ec.ec_ids,
                           ec.txp_ids, lengths, ec.num_ecs, T, TEMConfig())
    print(f"port batched_em: {it} iterations "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
