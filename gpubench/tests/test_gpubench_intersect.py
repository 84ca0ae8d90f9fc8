"""The two readers of the ``intersect`` span, ``intersect.s_per_sample``
and ``intersect.ns_per_member``, on a run of the tiny ``fam`` cell (a
world of gene families and pseudogenes, whose classes span genes): each
reads a finite positive value there, and None on a run whose samples lack
the span or its counter, as a program without them gives."""

import math

import pytest

from gpubench import manifest, run
from gpubench.tests import tiny

SEED = 2**31 + 91
READERS = ("intersect.s_per_sample", "intersect.ns_per_member")


@pytest.fixture(scope="module")
def fam_run(tmp_path_factory):
    """The ``run.Run`` a traced run of the ``fam`` cell hands its
    readers."""
    tmp = tmp_path_factory.mktemp("intersect")
    root = tiny.make_root(tmp)
    bench = manifest.load_benchmark(root / "BENCHMARK.json")
    seen = []
    real = run.read_metrics

    def keep(bench, workload, trace, r, end_to_end, root, log):
        seen.append(r)
        return real(bench, workload, trace, r, end_to_end, root, log)

    run.read_metrics = keep
    try:
        res = run.run_cell(bench, "fam", SEED, 0.5, True, device="cpu",
                           root=root, cache=root.parent / "cache", tmp=tmp,
                           log=lambda m: None)
    finally:
        run.read_metrics = real
    assert res["correct"], res["checks"]
    return res, seen[0]


@pytest.mark.parametrize("name", READERS)
def test_reads_the_span(fam_run, name):
    res, r = fam_run
    v = manifest.metric_reader(name)(r)
    assert v is not None and math.isfinite(v) and v > 0
    assert res["metrics"][name]["value"] == pytest.approx(v)
    for s in r.samples:
        assert s["intersect_members"] > 0
        assert 0 < s["intersect_s"] <= s["resolve_s"]


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("lacks", ["intersect_s", "intersect_members"])
def test_none_without_the_span(fam_run, name, lacks):
    _, r = fam_run
    old = run.Run()
    old.samples = [{k: v for k, v in s.items() if k != lacks}
                   for s in r.samples]
    want_none = lacks == "intersect_s" or name.endswith("ns_per_member")
    got = manifest.metric_reader(name)(old)
    assert (got is None) == want_none, got


def test_ns_per_member_is_the_ratio(fam_run):
    _, r = fam_run
    t = sum(s["intersect_s"] for s in r.samples)
    n = sum(s["intersect_members"] for s in r.samples)
    assert manifest.metric_reader("intersect.ns_per_member")(r) == (
        pytest.approx(1e9 * t / n))
