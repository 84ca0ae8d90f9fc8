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


# ---- the tiled fixed point (one launch, components in shared memory) --------

_TILED = ("tile_t0", "tile_e0", "tile_z0", "rows_t", "rows_e", "ec_off",
          "txp", "txp_off", "csc")


def _tiles_np(tl):
    return {k: getattr(tl, k).numpy().astype(np.int64) for k in _TILED}


def _tile_rows(a, i):
    """Tile (or global set) i's local arrays."""
    t0, t1 = a["tile_t0"][i], a["tile_t0"][i + 1]
    e0, e1 = a["tile_e0"][i], a["tile_e0"][i + 1]
    z0, z1 = a["tile_z0"][i], a["tile_z0"][i + 1]
    return (a["rows_t"][t0:t1], a["rows_e"][e0:e1],
            a["ec_off"][e0 + i:e1 + i + 1], a["txp"][z0:z1],
            a["txp_off"][t0 + i:t1 + i + 1], a["csc"][z0:z1])


def model_tiled(alpha, n, scale, tl, steps, divide):
    """A3's tiled launch in numpy, ``steps`` iterations from alpha (T, B):
    each (tile, slice) item on its own local copy (local CSR and CSC,
    iterate updated in place, d per step), then the global set over whole
    rows with global member ids. Returns (prev, last)."""
    a = _tiles_np(tl)
    T, B = alpha.shape
    dt = alpha.dtype.type
    prev, last = alpha.copy(), alpha.copy()

    def weight(x, s):
        return x / s if divide else x * s

    def run(cur, sc, nn, ec_off, txp, txp_off, csc, rows):
        """steps on cur (rows x w), members addressed by ``txp`` into cur
        and sc; returns the last two iterates of ``rows``."""
        old = cur[rows]
        for _ in range(steps):
            d = np.zeros((len(ec_off) - 1, cur.shape[1]), cur.dtype)
            for e in range(d.shape[0]):
                acc = np.zeros(cur.shape[1], cur.dtype)
                for j in range(ec_off[e], ec_off[e + 1]):
                    acc = acc + weight(cur[txp[j]], sc[txp[j]])
                d[e] = acc
            old = cur[rows].copy()
            for k, t in enumerate(rows):
                x = weight(old[k], sc[t])
                acc = np.zeros(cur.shape[1], cur.dtype)
                for q in range(txp_off[k], txp_off[k + 1]):
                    c = csc[q]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        acc = acc + np.where(d[c] > 0, (nn[c] * x) / d[c],
                                             dt(0))
                cur[t] = acc
        return old, cur[rows]

    for i in range(tl.ntiles):
        rows_t, rows_e, *csr = _tile_rows(a, i)
        for j in range(tl.slices):
            b0, b1 = j * tl.width, min(B, (j + 1) * tl.width)
            cur = alpha[rows_t, b0:b1].copy()
            old, new = run(cur, scale[rows_t], n[rows_e, b0:b1], *csr,
                           np.arange(len(rows_t)))
            prev[rows_t, b0:b1], last[rows_t, b0:b1] = old, new
    rows_t, rows_e, *csr = _tile_rows(a, tl.ntiles)
    if len(rows_t):
        cur = alpha.copy()
        old, new = run(cur, scale, n[rows_e], *csr, rows_t)
        prev[rows_t], last[rows_t] = old, new
    return prev, last


def _components(members, T):
    """Connected components of the EC-transcript graph by union-find:
    (label of each transcript, label of each EC)."""
    parent = list(range(T + len(members)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e, m in enumerate(members):
        for t in m:
            parent[find(T + e)] = find(int(t))
    lab = np.array([find(x) for x in range(len(parent))])
    return lab[:T], lab[T:]


def _gene_table(seed, genes=25, chain=30):
    """An EC table shaped like a transcriptome's: genes of 1-4 isoforms
    with ECs over subsets of a gene's isoforms (members in no sorted
    order), one gene family of ``chain`` transcripts linked EC by EC
    (larger than a small tile), two transcripts in no EC, two empty ECs;
    the ECs shuffled; counts with zeros; lengths."""
    rng = np.random.default_rng(seed)
    members, T = [], 0
    for _ in range(genes):
        k = int(rng.integers(1, 5))
        for _ in range(int(rng.integers(1, 2 * k + 1))):
            members.append(T + rng.choice(k, size=int(rng.integers(1, k + 1)),
                                          replace=False))
        T += k
    members += [np.array([T + j + 1, T + j], np.int64)
                for j in range(chain - 1)]
    T += chain + 2
    members += [np.zeros(0, np.int64)] * 2
    members = [members[k].astype(np.int32)
               for k in rng.permutation(len(members))]
    counts = rng.integers(0, 400, size=len(members)).astype(np.float64)
    counts[::7] = 0
    lengths = rng.integers(250, 3000, size=T).astype(np.int32)
    return members, counts, lengths


@pytest.mark.parametrize("capacity,blocks", [(100_000, 8), (2_000, 4),
                                             (600, 64)],
                         ids=["one_tile", "streamed", "global"])
@pytest.mark.parametrize("B", [1, 3, 100])
def test_tiled_layout_covers_every_entry_once(B, capacity, blocks):
    """Every (EC, member) entry lies in exactly one tile or in the global
    set, in CSR order within its EC and in CSC order within its
    transcript; every component lies whole in one tile or in the global
    set; every tile's item fits ``capacity``."""
    members, counts, lengths = _gene_table(80 + B)
    T = lengths.size
    E = len(members)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    lay = tem.csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    tl = em_csr_cuda.tiled_layout(lay, B, 4, capacity, blocks)
    a = _tiles_np(tl)
    assert sorted(a["rows_t"]) == list(range(T))
    assert sorted(a["rows_e"]) == list(range(E))
    width, slices = em_csr_cuda.slicing(B)
    assert (tl.width, tl.slices) == (width, slices) and width * slices >= B
    assert width <= em_csr_cuda.SLICE_MAX and (slices - 1) * width < B
    comp_t, comp_e = _components(members, T)
    csr_pairs, csc_pairs = [], []
    for i in range(tl.ntiles + 1):
        rows_t, rows_e, ec_off, txp, txp_off, csc = _tile_rows(a, i)
        glob_t = txp if i == tl.ntiles else rows_t[txp]
        for e, c in enumerate(rows_e):
            got = glob_t[ec_off[e]:ec_off[e + 1]]
            np.testing.assert_array_equal(got, np.asarray(members[c]))
            csr_pairs += [(c, t) for t in got]
        for k, t in enumerate(rows_t):
            run = rows_e[csc[txp_off[k]:txp_off[k + 1]]]
            assert (np.diff(run) > 0).all()  # nnz order: ECs ascend
            csc_pairs += [(c, t) for c in run]
        assert ec_off[0] == 0 and txp_off[0] == 0
        assert ec_off[-1] == txp_off[-1] == len(txp) == len(csc)
        labels = set(comp_t[rows_t]) | set(comp_e[rows_e])
        if i < tl.ntiles:
            assert em_csr_cuda.item_bytes(len(rows_e), len(rows_t), len(txp),
                                          width, 4) <= min(tl.smem, capacity)
            # no component of this tile has a row elsewhere
            assert (np.isin(comp_t, list(labels)).sum() == len(rows_t)
                    and np.isin(comp_e, list(labels)).sum() == len(rows_e))
    entries = sorted((int(c), int(t)) for c, m in enumerate(members)
                     for t in m)
    assert sorted(csr_pairs) == entries and sorted(csc_pairs) == entries
    assert tl.components == len(set(comp_t) | set(comp_e))
    assert tl.resident == (tl.ntiles * slices <= blocks)
    # the global set: exactly the components too large for a tile alone
    sizes = np.array([m.size for m in members])
    big = set()
    for lab in set(comp_t) | set(comp_e):
        ne, nt = int((comp_e == lab).sum()), int((comp_t == lab).sum())
        nz = int(sizes[comp_e == lab].sum())
        if 4 * (ne + nt + 3 * nz) + 4 * (nt + width * (2 * nt + 2 * ne + nz)) \
                + 23 > capacity:
            big.add(lab)
    rows_t, rows_e = _tile_rows(a, tl.ntiles)[:2]
    assert set(rows_t) == set(np.flatnonzero(np.isin(comp_t, list(big))))
    assert set(rows_e) == set(np.flatnonzero(np.isin(comp_e, list(big))))
    assert tl.global_rows == (len(rows_t), len(rows_e))
    assert tl.largest[0] >= 30  # the gene family
    assert bool(big) == (capacity == 600) or capacity == 2_000
    if capacity == 100_000:
        assert tl.ntiles <= max(blocks // slices, 1)


@pytest.mark.parametrize("capacity", [100_000, 2_000, 600],
                         ids=["one_tile", "streamed", "global"])
@pytest.mark.parametrize("B", [1, 3, 100])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_tiled_model_equals_plain_bits(dtype, B, capacity):
    """The tiled schedule (items of tiles x slices on local indices, the
    global set on global ones) gives the bits of ``_batched_iter`` and,
    at B = 1, of ``em_step``: the last two of 4 iterates."""
    np_dt, _ = DTYPES[dtype]
    members, counts, lengths = _gene_table(90 + B)
    T, E = lengths.size, len(members)
    ec = tem.build_ec_table(members, counts, T, device="cpu")
    lay = tem.csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    tl = em_csr_cuda.tiled_layout(lay, B, np.dtype(np_dt).itemsize,
                                  capacity, 16)
    rng = np.random.default_rng(B)
    n = rng.integers(0, 300, size=(E, B)).astype(np_dt)
    n[::5] = 0
    eff = np.maximum(lengths - 180.0, 1.0).astype(np_dt)
    alpha = (rng.random((T, B)) * 50).astype(np_dt)
    alpha[::6] = 0
    forms = [(False, (1.0 / eff).astype(np_dt))]
    if B == 1:
        forms.append((True, eff))
    for divide, scale in forms:
        got = model_tiled(alpha, n, scale, tl, 4, divide)
        ts = torch.from_numpy
        want = em_csr_cuda.plain_steps(
            ts(alpha[:, 0]) if divide else ts(alpha),
            ts(n[:, 0]) if divide else ts(n), ts(scale), lay, 4, divide)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[:, 0] if divide else g,
                                          w.numpy())


def model_test(prev, new, rel_tol, abs_floor, count_floor):
    """The kernel's convergence test in numpy, in the iterates' type: the
    tolerances rounded to it, each active entry's relative change as an
    unsigned key (a NaN the largest), the max of the keys, then the
    compare."""
    f = new.dtype.type
    bits = {4: np.uint32, 8: np.uint64}[new.dtype.itemsize]
    active = new > f(count_floor)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rel = np.abs(new - prev) / (new + f(abs_floor))
    key = rel.view(bits).astype(np.uint64)
    key[np.isnan(rel)] = np.uint64(2**64 - 1)
    if not active.any():
        return False
    top = key[active].max()
    if top == np.uint64(2**64 - 1):
        return False
    return bool(np.array([top], bits).view(new.dtype)[0] < f(rel_tol))


def _test_cases(np_dt):
    """(name, prev, new, cfg) pairs around each edge of the test."""
    f = np_dt
    rng = np.random.default_rng(3)
    base = (rng.random(64) * 100 + 1).astype(f)
    cfg = EMConfig(rel_tol=1e-4)
    near = base * f(1 + 1e-5)
    nan = near.copy()
    nan[5] = np.nan
    nan_prev = base.copy()
    nan_prev[7] = np.nan
    inf = near.copy()
    inf[9] = np.inf
    tiny = np.full(64, 1e-9, f)
    # rel exactly at rel_tol: prev = 0, new = x, rel = x / (x + floor)
    x = f(1.0)
    at = np.array([x / (x + f(cfg.abs_floor))], f)[0]
    exact = (np.array([0.0], f), np.array([1.0], f))
    return [("converging", base, near, cfg),
            ("far", base, base * f(1.5), cfg),
            ("nan_new", base, nan, cfg),
            ("nan_prev_active", nan_prev, near, cfg),
            ("inf", base, inf, cfg),
            ("no_active", tiny, tiny * f(0.5), cfg),
            ("zero", np.zeros(8, f), np.zeros(8, f), cfg),
            ("at_tol", *exact, dataclasses.replace(cfg, rel_tol=float(at))),
            ("above_tol", *exact, dataclasses.replace(
                cfg, rel_tol=float(np.nextafter(at, f(2))))),
            ("tol_not_in_type", *exact, dataclasses.replace(
                cfg, rel_tol=float(at) + 1e-12 * (np_dt == np.float32)))]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_in_launch_test_gives_convergence_check(dtype):
    """The kernel's test (the numpy model) decides as
    ``convergence_check`` on the CPU: NaN in an active entry, no active
    entry, rel exactly at rel_tol, and a float32 tolerance just above it
    that rounds to it in float32."""
    np_dt, _ = DTYPES[dtype]
    for name, prev, new, cfg in _test_cases(np_dt):
        want = bool(tem.convergence_check(torch.from_numpy(prev),
                                          torch.from_numpy(new), cfg))
        got = model_test(prev, new, cfg.rel_tol, cfg.abs_floor,
                         cfg.count_floor)
        assert got == want, name
    names = {n: bool(tem.convergence_check(torch.from_numpy(p),
                                           torch.from_numpy(q), c))
             for n, p, q, c in _test_cases(np_dt)}
    # a NaN iterate entry is not active; a NaN change of an active one
    # (NaN before, or inf - inf) keeps the run going
    assert names["converging"] and names["nan_new"]
    assert not names["nan_prev_active"] and not names["inf"]
    assert not names["no_active"] and not names["zero"]
    assert not names["at_tol"] and names["above_tol"]
    assert not names["tol_not_in_type"]  # rel_tol rounds to the type


def model_schedule(decide, C, it_init, min_iters, max_iters):
    """The kernel's loop over blocks of steps: ``decide(k)`` is block k's
    test; returns (it, converged, blocks run)."""
    it, converged, k = it_init, False, 0
    while it < max_iters:
        it += C
        converged = decide(k) and it >= min_iters
        k += 1
        if converged:
            break
    return it, converged, k


@pytest.mark.parametrize("C,it_init,min_iters,max_iters,passes", [
    (16, 0, 10, 10000, 3),      # converges at block 3
    (16, 0, 48, 10000, 1),      # it + C == min_iters at block 3
    (16, 0, 49, 10000, 1),      # min_iters holds it off one more block
    (7, 0, 0, 25, 99),          # max_iters not a multiple of C: it = 28
    (16, 32, 10, 100, 99),      # it_init > 0: 32 -> 112
    (16, 100, 10, 100, 0),      # it_init at max_iters: no block runs
    (1, 0, 0, 5, 2),
])
def test_schedule_model_equals_blocked_fixed_point(C, it_init, min_iters,
                                                   max_iters, passes):
    """The kernel's loop gives ``run_blocked_fixed_point``'s iteration
    count and converged flag: an EM map whose block k's test passes from
    block ``passes`` on (99: never)."""
    cfg = EMConfig(check_every=C, min_iters=min_iters, max_iters=max_iters,
                   rel_tol=1e-3)
    calls = []

    def em_iter(a):
        calls.append(1)
        k = (len(calls) - 1) // C
        return a * (1 + 1e-4 if k >= passes else 2.0)

    it, conv, _ = tem.run_blocked_fixed_point(
        em_iter, torch.ones(4, dtype=torch.float64), cfg, it_init=it_init)
    got = model_schedule(lambda k: k >= passes, C, it_init, min_iters,
                         max_iters)
    assert (it, conv) == got[:2]
    assert len(calls) == got[2] * C


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("divide", [False, True], ids=["batched", "single"])
def test_em_fixed_point_on_cpu_is_blocked_plain_loop(divide, dtype):
    """``em_fixed_point`` on CPU tensors is ``run_blocked_fixed_point``
    over the plain step: the same (alpha, it, converged), from ``it_init``
    too, and it counts no launch."""
    np_dt, _ = DTYPES[dtype]
    B = 1 if divide else 3
    _, ec, layout, n, eff, alpha = _system(45, B, np_dt)
    ts = torch.from_numpy
    if divide:
        args = (ts(alpha[:, 0]), ts(n[:, 0]), ts(eff))
    else:
        args = (ts(alpha), ts(n), ts((1.0 / eff).astype(np_dt)))
    step = em_csr_cuda.plain_iter(*args[1:], layout, divide)
    before = em_csr_cuda.em_steps.launches
    for cfg, it_init in ((EMConfig(rel_tol=1e-5, max_iters=4000), 0),
                         (EMConfig(rel_tol=0.0, max_iters=50,
                                   check_every=7), 14)):
        got = em_csr_cuda.em_fixed_point(*args, layout, cfg, divide,
                                         it_init=it_init)
        it, conv, want = tem.run_blocked_fixed_point(step, args[0], cfg,
                                                     it_init=it_init)
        assert (got[1], got[2]) == (it, conv)
        assert torch.equal(got[0], want)
    assert em_csr_cuda.em_steps.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_ec_sums_plain_in_nnz_order(dtype):
    """A4's wrapper on CPU tensors (its plain version): each EC's sum in
    nnz order from 0, equal in bits to a numpy loop in that order and to
    the CPU's ``index_add_``, on a table with empty ECs (the first, one
    inside, the last two) and an EC of 70 members; no launch."""
    rng = np.random.default_rng(11)
    sizes = rng.integers(0, 5, size=40)
    sizes[[0, 17, 38, 39]] = 0
    sizes[5] = 70
    ids = torch.from_numpy(np.repeat(np.arange(40), sizes))
    w = torch.from_numpy(rng.random(int(sizes.sum())) * 7).to(dtype)
    before = em_csr_cuda.ec_sums.launches
    got = em_csr_cuda.ec_sums(w, ids, 40)
    assert em_csr_cuda.ec_sums.launches == before
    wn = w.numpy()
    want = np.zeros(40, wn.dtype)
    for z, c in enumerate(ids.numpy()):
        want[c] = want[c] + wn[z]
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, torch.zeros(40, dtype=dtype).index_add_(0, ids,
                                                                     w))
