"""A3, the CSR EM iteration (``seekmer_tpu_torch/ops/em_csr_cuda.py``,
``csrc/em_csr.cu``), on the CPU.

The kernel runs only on the card; here its schedule is a numpy model
(E-phase over each EC's members in CSR order, M-phase over each
transcript's CSC run in nnz order, the kernel's expressions in explicit
float32/float64 arrays), held bit for bit against the plain versions
(``em_step``, ``_batched_iter``) and within float32 rounding of the JAX
steps on the same numpy inputs. Then the layout helper, the wrapper's plain
route, and ``run_em`` / ``batched_em`` giving the iteration counts and bits
of the loop they ran before the wrapper existed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seekmer_tpu.em import bootstrap as jbs
from seekmer_tpu.em import em as jem
from seekmer_tpu_torch.config import EMConfig
from seekmer_tpu_torch.em import bootstrap as tbs
from seekmer_tpu_torch.em import em as tem
from seekmer_tpu_torch.ops import em_csr_cuda

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}


def _table(seed, T=40, E=90):
    """Member lists in no sorted order, with two empty ECs and three
    transcripts (the last) in no EC; counts with zeros; lengths."""
    rng = np.random.default_rng(seed)
    members = [rng.choice(T - 3, size=int(rng.integers(1, 7)), replace=False)
               .astype(np.int32) for _ in range(E)]
    members[4] = members[4][:0]
    members[E - 1] = members[E - 1][:0]
    counts = rng.integers(0, 400, size=E).astype(np.float64)
    counts[::7] = 0
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    return members, counts, lengths


def _layout_np(layout):
    return [t.numpy() for t in (layout.ec_off, layout.txp, layout.txp_off,
                                layout.csc_ec)]


def model_steps(alpha, n, scale, layout, steps, divide):
    """A3's schedule in numpy: ``steps`` iterations from alpha (T, B) with
    counts n (E, B), in alpha's dtype. Each (row, replicate) item is one
    thread of the kernel; a thread's sum is an explicit chain of adds."""
    ec_off, txp, txp_off, csc_ec = _layout_np(layout)
    dt = alpha.dtype.type
    T, B = alpha.shape
    E = n.shape[0]

    def weight(src, t):
        return src[t] / scale[t] if divide else src[t] * scale[t]

    src = alpha
    for _ in range(steps):
        d = np.zeros((E, B), alpha.dtype)
        for c in range(E):
            acc = np.zeros(B, alpha.dtype)
            for j in range(ec_off[c], ec_off[c + 1]):
                acc = acc + weight(src, txp[j])
            d[c] = acc
        dst = np.zeros((T, B), alpha.dtype)
        for t in range(T):
            w = weight(src, t)
            acc = np.zeros(B, alpha.dtype)
            for k in range(txp_off[t], txp_off[t + 1]):
                c = csc_ec[k]
                with np.errstate(divide="ignore", invalid="ignore"):
                    r = np.where(d[c] > 0, (n[c] * w) / d[c], dt(0))
                acc = acc + r
            dst[t] = acc
        src = dst
    return src


def _system(seed, B, np_dt, T=40, E=90):
    """The table's layout, counts (E, B), lengths-derived eff, and a start
    iterate with zero rows (ECs whose d is 0)."""
    members, counts, lengths = _table(seed, T, E)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    layout = tem.csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    rng = np.random.default_rng(seed + 1)
    n = rng.integers(0, 300, size=(E, B)).astype(np_dt)
    n[::5] = 0
    eff = np.maximum(lengths - 180.0, 1.0).astype(np_dt)
    alpha = (rng.random((T, B)) * 50).astype(np_dt)
    alpha[::6] = 0
    return members, ec, layout, n, eff, alpha


def test_csr_layout():
    """Offsets, the stable transcript order of the nnz, empty ECs and
    transcripts in no EC."""
    members, counts, lengths = _table(3)
    T, E = lengths.size, len(members)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    lay = tem.csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    sizes = np.array([m.size for m in members])
    txp = np.concatenate(members)
    perm = np.argsort(txp, kind="stable")
    np.testing.assert_array_equal(lay.ec_off.numpy(),
                                  np.concatenate([[0], np.cumsum(sizes)]))
    np.testing.assert_array_equal(lay.txp.numpy(), txp)
    deg = np.bincount(txp, minlength=T)
    np.testing.assert_array_equal(lay.txp_off.numpy(),
                                  np.concatenate([[0], np.cumsum(deg)]))
    ec_ids = np.repeat(np.arange(E), sizes)
    np.testing.assert_array_equal(lay.csc_ec.numpy(), ec_ids[perm])
    assert all(t.dtype == torch.int32 for t in
               (lay.ec_off, lay.txp, lay.txp_off, lay.csc_ec))
    assert lay.ec_off[5] == lay.ec_off[4]  # EC 4 is empty
    assert (deg[-3:] == 0).all() and lay.txp_off[-1] == lay.txp_off[-4]
    # each transcript's run keeps nnz order (the stable sort): with EC ids
    # sorted, a run's ECs ascend (an EC holds a transcript at most once)
    for t in range(T):
        run = lay.csc_ec[lay.txp_off[t]:lay.txp_off[t + 1]].numpy()
        assert (np.diff(run) > 0).all()
    with pytest.raises(ValueError, match="sorted"):
        tem.csr_layout(ec.ec_ids.flip(0), ec.txp_ids, E, T)
    empty = tem.csr_layout(torch.zeros(0, dtype=torch.int64),
                           torch.zeros(0, dtype=torch.int64), 3, 4)
    assert empty.ec_off.tolist() == [0] * 4
    assert empty.txp_off.tolist() == [0] * 5


@pytest.mark.parametrize("B", [1, 3, 100])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_model_equals_plain_batched_bits(dtype, B):
    """Three batched steps: the model's bits equal ``_batched_iter``'s."""
    np_dt, t_dt = DTYPES[dtype]
    _, ec, layout, n, eff, alpha = _system(10 + B, B, np_dt)
    inv = (1.0 / eff).astype(np_dt)
    got = model_steps(alpha, n, inv, layout, 3, divide=False)
    it = tbs._batched_iter(torch.from_numpy(n)[ec.ec_ids],
                           torch.from_numpy(inv)[ec.txp_ids][:, None],
                           ec.ec_ids, ec.txp_ids, ec.num_ecs,
                           ec.num_transcripts)
    a = torch.from_numpy(alpha)
    for _ in range(3):
        a = it(a)
    assert a.dtype == t_dt
    np.testing.assert_array_equal(got, a.numpy())
    assert (got[-3:] == 0).all()  # transcripts in no EC


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_model_equals_plain_single_run_bits(dtype):
    """Three single-run steps (w = alpha / eff): equal to ``em_step``."""
    np_dt, _ = DTYPES[dtype]
    _, ec, layout, n, eff, alpha = _system(20, 1, np_dt)
    got = model_steps(alpha, n, eff, layout, 3, divide=True)[:, 0]
    ec = ec._replace(counts=torch.from_numpy(n[:, 0]))
    a = torch.from_numpy(alpha[:, 0])
    for _ in range(3):
        a = tem.em_step(a, ec, torch.from_numpy(eff))
    np.testing.assert_array_equal(got, a.numpy())


@pytest.mark.parametrize("B", [1, 3, 100])
def test_model_within_float32_rounding_of_jax(B):
    """One float32 step of the model against the JAX ``_batched_iter`` and
    (at B = 1) ``em_step`` on the same numpy inputs: the sums there may run
    in another order, so each value agrees within a few float32 roundings
    of its terms (at most 7 of them; rtol 1e-5, atol 1e-5 reads)."""
    members, ec, layout, n, eff, alpha = _system(30 + B, B, np.float32)
    inv = (1.0 / eff).astype(np.float32)
    got = model_steps(alpha, n, inv, layout, 1, divide=False)
    jec = jem.build_ec_table(members, n[:, 0], alpha.shape[0])
    jit = jbs._batched_iter(jnp.asarray(n)[jec.ec_ids],
                            jnp.asarray(inv)[jec.txp_ids][:, None],
                            jec.ec_ids, jec.txp_ids, jec.num_ecs,
                            jec.num_transcripts)
    want = np.asarray(jit(jnp.asarray(alpha)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if B == 1:
        one = model_steps(alpha, n, eff, layout, 1, divide=True)[:, 0]
        jone = np.asarray(jem.em_step(jnp.asarray(alpha[:, 0]), jec,
                                      jnp.asarray(eff)))
        np.testing.assert_allclose(one, jone, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("divide", [False, True], ids=["batched", "single"])
def test_em_steps_on_cpu_is_plain_iterations(divide, steps):
    """``em_steps`` on CPU tensors returns the last two of ``steps`` plain
    iterations, and counts no launch."""
    B = 1 if divide else 4
    _, ec, layout, n, eff, alpha = _system(40, B, np.float32)
    inv = (1.0 / eff).astype(np.float32)
    if divide:
        args = (torch.from_numpy(alpha[:, 0]), torch.from_numpy(n[:, 0]),
                torch.from_numpy(eff))
        ec1 = ec._replace(counts=args[1])

        def step(a):
            return tem.em_step(a, ec1, args[2])
    else:
        args = (torch.from_numpy(alpha), torch.from_numpy(n),
                torch.from_numpy(inv))
        step = tbs._batched_iter(args[1][ec.ec_ids],
                                 args[2][ec.txp_ids][:, None], ec.ec_ids,
                                 ec.txp_ids, ec.num_ecs, ec.num_transcripts)
    before = em_csr_cuda.em_steps.launches
    prev, last = em_csr_cuda.em_steps(*args, layout, steps, divide=divide)
    chain = [args[0]]
    for _ in range(steps):
        chain.append(step(chain[-1]))
    assert torch.equal(prev, chain[-2]) and torch.equal(last, chain[-1])
    assert em_csr_cuda.em_steps.launches == before
    with pytest.raises(ValueError, match="at least one"):
        em_csr_cuda.em_steps(*args, layout, 0, divide=divide)


def _old_fixed_point(em_iter, alpha0, cfg):
    """The blocked loop as ``run_em`` / ``batched_em`` ran it before the
    wrapper: one plain step at a time."""
    if cfg.accel == "squarem":
        it, _, a = tem.run_blocked_fixed_point(
            lambda x: tem.squarem_cycle(em_iter, x), alpha0,
            tem.accel_schedule(cfg))
        return a, it * 3
    it, _, a = tem.run_blocked_fixed_point(em_iter, alpha0, cfg)
    return a, it


@pytest.mark.parametrize("accel", ["none", "squarem"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_run_em_unchanged_on_cpu(dtype, accel):
    """run_em's CSR branch on CPU tensors: the iteration count and bits of
    the plain loop."""
    members, counts, lengths = _table(50)
    T = lengths.size
    _, t_dt = DTYPES[dtype]
    cfg = EMConfig(rel_tol=1e-7, max_iters=3000, accel=accel,
                   use_x64=dtype == "f64")
    ec = tem.build_ec_table(members, counts, T, dtype=t_dt, device="cpu")
    alpha, it = tem.run_em(ec, lengths, cfg)
    eff = tem.effective_lengths(lengths, cfg, t_dt, "cpu")
    want, it_w = _old_fixed_point(lambda a: tem.em_step(a, ec, eff),
                                  (ec.counts.sum() / T).repeat(T), cfg)
    assert it == it_w and 0 < it < cfg.max_iters
    assert torch.equal(alpha, want)


@pytest.mark.parametrize("accel", ["none", "squarem"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batched_em_unchanged_on_cpu(dtype, accel):
    """batched_em on CPU tensors: the iteration count and bits of the plain
    loop over (nnz, B) gathers."""
    members, counts, lengths = _table(60)
    T, B = lengths.size, 5
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(61)
    N = int(counts.sum())
    cmat = torch.from_numpy(np.stack(
        [rng.multinomial(N, counts / N) for _ in range(B)]).astype(np_dt))
    cfg = EMConfig(rel_tol=1e-5, max_iters=600, accel=accel)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    alpha, it = tbs.batched_em(cmat, ec.ec_ids, ec.txp_ids, lengths,
                               ec.num_ecs, T, cfg)
    eff = tem.effective_lengths(lengths, cfg, t_dt, "cpu")
    step = tbs._batched_iter(cmat.t()[ec.ec_ids],
                             (1.0 / eff)[ec.txp_ids][:, None], ec.ec_ids,
                             ec.txp_ids, ec.num_ecs, T)
    alpha0 = (cmat.sum(dim=1)[None, :] / T).expand(T, B).contiguous()
    want, it_w = _old_fixed_point(step, alpha0, cfg)
    assert it == it_w and 0 < it <= cfg.max_iters + cfg.check_every
    assert torch.equal(alpha, want.t())


def test_blocked_schedule_with_a_block_function():
    """A block of check_every steps is one em_steps call: the blocked
    schedule with the block function gives the per-step loop's count and
    bits at a check_every that does not divide max_iters."""
    _, ec, layout, n, eff, alpha = _system(70, 3, np.float32)
    inv = torch.from_numpy((1.0 / eff).astype(np.float32))
    counts = torch.from_numpy(n)
    cfg = dataclasses.replace(EMConfig(), rel_tol=0.0, max_iters=25,
                              check_every=7)

    def block(a, steps):
        return em_csr_cuda.em_steps(a, counts, inv, layout, steps, False)

    a0 = torch.from_numpy(alpha)
    it, conv, got = tem.run_blocked_fixed_point(
        lambda a: block(a, 1)[1], a0, cfg, em_block=block)
    it_w, _, want = tem.run_blocked_fixed_point(
        lambda a: block(a, 1)[1], a0, cfg)
    assert (it, conv, it_w) == (28, False, 28)
    assert torch.equal(got, want)
