"""The multi-EC intersections: I2's plain version
(``ops/intersect_cuda.plain``) and the port's ``resolve_signatures`` on
CPU tensors against the JAX package's ``resolve_signatures`` and its
loop of ``np.intersect1d``: equal member lists, counts and dropped
fragments, and the same flat lists, lengths and counts, in the same order
and types, handed to ``_group_member_lists``.
"""

import numpy as np
import pytest
import torch

from seekmer_tpu.map import driver as jdriver
from seekmer_tpu_torch.map import driver as tdriver
from seekmer_tpu_torch.map.driver import MapResult, resolve_signatures
from seekmer_tpu_torch.ops import intersect_cuda
from seekmer_tpu_torch.utils.metrics import Metrics
from tests.synthetic_intersect import SIG_PAD, cases, paralog_like, reference

FIXED = ["no_rows", "one_row", "two_ecs", "sixteen_ecs", "empty", "over_32",
         "over_1024"]
SEEDS = [0, 1, 2, 3]


class CSRIndex:
    """The two arrays of a ``KMerIndex`` that resolving reads."""

    def __init__(self, offsets, transcripts):
        self.ec_offsets, self.ec_transcripts = offsets, transcripts

    def ec_members(self, ec):
        return self.ec_transcripts[self.ec_offsets[ec]:
                                   self.ec_offsets[ec + 1]]


def _case(name):
    if name.startswith("seed"):
        return paralog_like(np.random.default_rng(int(name[4:])), 300)
    return cases()[name]


CASES = FIXED + [f"seed{s}" for s in SEEDS]


def _result(rows, offsets, seed):
    """A MapResult of the case's multi-EC rows among single-EC ones, in a
    random order, with random counts."""
    rng = np.random.default_rng(seed)
    n_ec = offsets.size - 1
    singles = np.full((min(n_ec, 40), rows.shape[1]), SIG_PAD, np.int32)
    singles[:, 0] = rng.choice(n_ec, size=singles.shape[0], replace=False)
    sigs = np.concatenate([rows, singles])[rng.permutation(
        rows.shape[0] + singles.shape[0])]
    counts = rng.integers(1, 50, size=sigs.shape[0]).astype(np.int64)
    return MapResult(sigs=sigs, sig_counts=counts, total_reads=0,
                     mapped=int(counts.sum()), overflow=0)


def _recorded(monkeypatch, module):
    """``module._group_member_lists`` recording its arguments."""
    seen = []
    real = module._group_member_lists

    def spy(flat, lens, counts):
        seen.append((flat, lens, counts))
        return real(flat, lens, counts)

    monkeypatch.setattr(module, "_group_member_lists", spy)
    return seen


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_intersect1d(name):
    rows, off, tr = _case(name)
    got = intersect_cuda.plain(*(torch.from_numpy(a) for a in (rows, off,
                                                               tr)))
    want = reference(rows, off, tr)
    lens, starts, values = (got.lens.numpy(), got.starts.numpy(),
                            got.values.numpy())
    assert lens.tolist() == [w.size for w in want]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(values[starts[i]:starts[i] + lens[i]],
                                      w)
    real = rows != SIG_PAD
    ec = np.where(real, rows, 0)
    sizes = np.where(real, off[ec + 1].astype(np.int64) - off[ec], 0)
    assert got.members == int(sizes.sum())
    # a slot holds the row's shortest list
    slots = np.diff(starts, append=values.size)
    shortest = np.where(real, sizes, np.iinfo(np.int64).max).min(
        axis=1, initial=np.iinfo(np.int64).max)
    np.testing.assert_array_equal(slots, np.where(real.any(axis=1),
                                                  shortest, 0))


@pytest.mark.parametrize("carried", [False, True], ids=["no_csr", "cpu_csr"])
@pytest.mark.parametrize("name", CASES)
def test_resolve_matches_jax(monkeypatch, name, carried):
    rows, off, tr = _case(name)
    index = CSRIndex(off, tr)
    result = _result(rows, off, seed=len(name))
    if carried:
        result.ec_csr = tdriver.upload_ec_csr(index, "cpu")
    want_args = _recorded(monkeypatch, jdriver)
    got_args = _recorded(monkeypatch, tdriver)
    m_w, c_w, d_w = jdriver.resolve_signatures(result, index)
    metrics = Metrics()
    with metrics.active():
        m_g, c_g, d_g = resolve_signatures(result, index)
    assert d_g == d_w and type(d_g) is int
    np.testing.assert_array_equal(c_g, c_w)
    assert len(m_g) == len(m_w)
    for a, b in zip(m_g, m_w):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    (want,), (got,) = want_args, got_args
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    multi = rows[(rows != SIG_PAD).sum(axis=1) > 1]
    real = multi != SIG_PAD
    ec = np.where(real, multi, 0)
    assert metrics.counters["intersect_members"] == int(
        np.where(real, off[ec + 1] - off[ec], 0).sum())
    assert metrics.counters["intersect_on_device"] == 0
    assert "intersect" in metrics.timings


def test_resolve_takes_one_call(monkeypatch):
    """Every multi-EC row goes through one intersect call."""
    rows, off, tr = _case("seed0")
    calls = []
    real = intersect_cuda.intersect

    def spy(r, *csr):
        calls.append(r.shape[0])
        return real(r, *csr)

    spy.launches = real.launches
    monkeypatch.setattr(intersect_cuda, "intersect", spy)
    resolve_signatures(_result(rows, off, seed=1), CSRIndex(off, tr))
    assert calls == [rows.shape[0]]


def _bad_inputs():
    rows, off, tr = cases()["two_ecs"]
    t = [torch.from_numpy(a) for a in (rows, off, tr)]
    wide = torch.full((2, 2 * rows.shape[1]), SIG_PAD, dtype=torch.int32)
    return {
        "rows_dtype": ((t[0].to(torch.int64), t[1], t[2]), "int32"),
        "rows_rank": ((t[0][0], t[1], t[2]), r"\(M, C\)"),
        "rows_contiguity": ((wide[:, ::2], t[1], t[2]), "contiguous"),
        "rows_width": ((torch.full((1, intersect_cuda.MAX_WIDTH + 1),
                                   SIG_PAD, dtype=torch.int32), t[1], t[2]),
                       "at most"),
        "offsets_dtype": ((t[0], t[1].to(torch.int64), t[2]), "ec_offsets"),
        "transcripts_rank": ((t[0], t[1], t[2][None]), "ec_transcripts"),
        "transcripts_contiguity": ((t[0], t[1], torch.stack(
            [t[2], t[2]], dim=1)[:, 0]), "contiguous"),
    }


@pytest.mark.parametrize("what", list(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    args, match = _bad_inputs()[what]
    with pytest.raises(ValueError, match=match):
        intersect_cuda.intersect(*args)
