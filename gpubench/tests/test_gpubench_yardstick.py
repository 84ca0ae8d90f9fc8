"""The traced run's arithmetic on the CPU: the trace reduction (device
busy time, mirrored host ranges left out, idle gaps charged to ranges),
the K2 and A3 bounds, K2's bound over a sample for paired and single-end
lanes, and the per-layer readers on a run put together by hand."""

import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gpubench import manifest, run, trace
from gpubench.reference import kmers
from gpubench.yardstick import bounds, peaks


def ev(name, a, b, dev, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        is_user_annotation=annotation)


def test_reduce_events():
    events = [
        ev("gpubench.sample", 0, 1000, False, True),
        ev("resolve", 100, 400, False, True),
        ev("upload", 500, 600, False, True),
        ev("gpubench.sample", 0, 1000, True, True),  # mirrored: no work
        ev("map", 0, 500, True, False),  # a range by name, no work
        ev("kernel_a", 50, 100, True),
        ev("kernel_a", 80, 120, True),
        ev("Memcpy HtoD", 450, 550, True),
        ev("kernel_b", 900, 950, True),
    ]
    red = trace.reduce_events(events)
    assert red["busy_s"] == pytest.approx((70 + 100 + 50) / 1e6)
    assert red["window_s"] == pytest.approx(1000 / 1e6)
    assert red["per_op"]["kernel_a"] == (pytest.approx(90 / 1e6), 2)
    assert "gpubench.sample" not in red["per_op"]
    assert "map" not in red["per_op"]
    # gaps: 0-50 sample, 120-450 resolve, 550-900 sample, 950-1000 sample
    assert red["idle"]["resolve"] == pytest.approx(330 / 1e6)
    assert red["idle"]["gpubench.sample"] == pytest.approx(450 / 1e6)
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "Memcpy HtoD"
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert trace.device_seconds(red, "kernel_") == (
        pytest.approx(140 / 1e6), 3)


def test_idle_charged_to_innermost_span():
    """A gap is charged to the shortest range that holds it, whichever
    thread's: the feed loop's wait inside ``map``, the producer's pack
    inside its upload; a span's name mirrored on the device is no work."""
    events = [
        ev("map", 0, 1000, False, True),
        ev("map_wait", 100, 300, False, True),
        ev("upload", 500, 900, False, True),
        ev("pack", 550, 850, False, True),
        ev("map_wait", 100, 300, True),  # mirrored, without its flag
        ev("kernel_a", 0, 100, True),
        ev("kernel_a", 300, 500, True),
        ev("kernel_a", 900, 1000, True),
    ]
    red = trace.reduce_events(events)
    assert red["busy_s"] == pytest.approx(400 / 1e6)
    assert red["idle"] == pytest.approx({"map_wait": 200 / 1e6,
                                         "pack": 400 / 1e6})
    assert set(trace.RANGES) >= {"mapper", "index_upload", "index_layout",
                                 "map_wait", "fld", "finalize", "pack",
                                 "ec_table", "resample", "collect"}


def test_k2_bytes():
    # 100 bp reads pad to 128: P = 104 windows a mate at k 25
    b = bounds.k2_bytes(10, 2, 100, 25, 0, 0, 1 << 20, 32)
    assert b == 10 * 2 * 104 * 17
    one = bounds.k2_bytes(1, 1, 25, 25, 1, 1, 1 << 20, 32)
    assert one == pytest.approx(8 * 17 + 4 * 32 + 64)
    # many keys fill every bucket once at most
    full = bounds.k2_bytes(0, 1, 100, 25, 10 ** 9, 0, 1024, 32)
    assert full == pytest.approx(1024 * 128)
    assert bounds.k2_seconds(peaks.HBM_BYTES_S) == 1.0


def test_a3_seconds():
    E, T, nnz = 1000, 800, 3000
    s = bounds.a3_seconds(E, T, nnz, 100, 10000)
    ops = 10000 * (4 * nnz + T) * 100 + 625 * 5 * T * 100
    assert s == pytest.approx(ops / peaks.FP32_FLOPS)
    # one iteration: the bytes bound
    moved = 4 * (2 * T + E + T) + 4 * (E + T + 2) + 8 * nnz
    assert bounds.a3_seconds(E, T, nnz, 1, 1) == pytest.approx(
        moved / peaks.HBM_BYTES_S)


@pytest.mark.parametrize("paired", [False, True])
def test_k2_bound_over_a_sample(paired):
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 4, 3000).astype(np.uint8)
    tab = kmers.build_table(torch.from_numpy(seq), torch.tensor([3000]), 25)
    starts = rng.integers(0, 2900, 300)
    lane = np.stack([seq[s:s + 100] for s in starts])
    lanes1 = [lane[:150], lane[150:]]
    lanes2 = [lane[::-1][:150].copy(), lane[::-1][150:].copy()]
    got = run.k2_bound(tab, lanes1, lanes2 if paired else None, 25, 64,
                       (1024, 32), 100)
    want = 0.0
    for ln in (lanes1 if not paired else zip(lanes1, lanes2)):
        mates = ln if paired else (ln,)
        for s in range(0, 150, 64):
            keys = set()
            for m in mates:
                for row in m[s:s + 64]:
                    k, v = kmers.windows(torch.from_numpy(row), 25)
                    keys |= set(k[v].tolist())
            n = min(64, 150 - s)
            # every key of these reads is in the table
            want += bounds.k2_seconds(bounds.k2_bytes(
                n, 2 if paired else 1, 100, 25, len(keys), len(keys),
                1024, 32))
    assert got == pytest.approx(want)


def test_readers_on_a_run():
    r = run.Run()
    r.fragments = 1000
    r.samples = [{"map_s": 0.5, "resolve_s": 2.0, "em_s": 0.1,
                  "em_iterations": 100.0, "bootstrap_s": 1.0,
                  "mapper_s": 0.25, "map_wait_s": 0.25, "finalize_s": 0.05,
                  "resample_s": 0.02, "ec_table_s": 0.1, "collect_s": 0.05,
                  "wall_s": 4.2},
                 {"map_s": 1.5, "resolve_s": 4.0, "em_s": 0.3,
                  "em_iterations": 300.0, "bootstrap_s": 3.0,
                  "mapper_s": 0.75, "map_wait_s": 0.75, "finalize_s": 0.15,
                  "resample_s": 0.04, "ec_table_s": 0.3, "collect_s": 0.05,
                  "wall_s": 10.0}]
    r.index_load_s = 7.0
    r.baseline_fragments_per_s = 10.0
    r.k2_bound_s = 0.001
    r.a3_bound_s = 0.01
    r.trace = {"busy_s": 2.0, "window_s": 8.0, "idle": {},
               "per_op": {"x lookup_kernel<32> y": (0.004, 4),
                          "em_csr_kernel<float>": (0.5, 2)}}
    read = {m["name"]: manifest.metric_reader(m["name"])(r)
            for m in manifest.load_benchmark()["per_layer"]}
    assert read == pytest.approx({
        "index.load_s": 7.0, "map_stage.fragments_per_s": 1000.0,
        "vs_baseline": 10.0, "k2.roofline_pct": 50.0,
        "resolve.s_per_sample": 3.0, "em.iters_per_s": 1000.0,
        "bootstrap.s_per_sample": 2.0, "a3.roofline_pct": 2.0,
        "device.idle_pct": 75.0, "mapper.s_per_sample": 0.5,
        "finalize.s_per_sample": 0.1, "map_stage.wait_pct": 50.0,
        "resample.s_per_sample": 0.03,
        # 14.2 s of wall time, 13.9 s of it in top-level spans
        "quantifier.unstaged_pct": 100.0 * 0.3 / 14.2})
    # a sample without a span (a program that lacks it) reads nothing
    r.samples[1] = {k: v for k, v in r.samples[1].items()
                    if k not in ("mapper_s", "map_wait_s", "collect_s")}
    for name in ("mapper.s_per_sample", "map_stage.wait_pct",
                 "quantifier.unstaged_pct"):
        assert manifest.metric_reader(name)(r) is None, name


def test_reader_that_finds_nothing_is_left_out(tmp_path):
    """A per-layer metric whose reader returns None or a value that is not
    finite is left out of the line, and the others stay in it."""
    (tmp_path / "metrics").mkdir()
    for name, value in (("a", "None"), ("b", "float('nan')"), ("c", "2")):
        (tmp_path / "metrics" / f"{name}.py").write_text(
            f"def read(run):\n    return {value}\n")
    bench = {"per_layer": [{"name": n, "unit": "s"} for n in "abc"],
             "end_to_end": [{"name": "setup_s", "unit": "s"}]}
    said = []
    got = run.read_metrics(bench, "w", True, run.Run(), {}, tmp_path,
                           said.append)
    assert got == {"c": {"value": 2.0, "unit": "s"}}
    assert len(said) == 2 and "a found nothing" in said[0]
    assert run.read_metrics(bench, "w", False, run.Run(), {"setup_s": 3},
                            tmp_path, said.append) == {
        "setup_s": {"value": 3.0, "unit": "s"}}
