"""BENCHMARK.json and the files it names: names and units in the allowed
characters, every metric with one layer and one ``moves`` that its cells
report, every configuration, traffic mix and metric reader found by name,
bounds and the run length within the benchmark's budget."""

import json
import re

import pytest

from gpubench import manifest

BENCH = manifest.load_benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    raw = (manifest.REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (manifest.REPO / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    for w in BENCH["command"]:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [n for m, n in names if m]
    assert len(metric_names) == len(set(metric_names))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))


def test_end_to_end():
    assert 1 <= len(E2E) <= 16 and "setup_s" in E2E
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in E2E.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer():
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in E2E
        moved = E2E[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            # the cell reports the end-to-end metric this one moves
            assert "workloads" not in moved or w in moved["workloads"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    # one spelling a layer
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found(name):
    assert callable(manifest.metric_reader(name))


def test_reader_finds_nothing_returns_none():
    from gpubench.run import Run

    for m in BENCH["per_layer"]:
        if m["name"] == "index.load_s":
            continue
        assert manifest.metric_reader(m["name"])(Run()) is None, m["name"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    cfg = manifest.load_config(w["config"])
    mix = manifest.load_mix(w["traffic"])
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert mix["input"] in ("fastq", "pack_cache")
    assert NAME.match(w["traffic"])
    reports = [m for m in BENCH["per_layer"]
               if cell in m.get("workloads", CELLS)]
    assert reports
    assert [m for m in E2E.values()
            if m["name"] != "setup_s"
            and cell in m.get("workloads", CELLS)]
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_share():
    four = [w for w in CELLS.values() if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    assert LINE.match(entry["why"]) and LINE.match(entry["source"])
    assert len(entry["reduced"]) <= 16
    cfg = json.loads((manifest.REPO / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert key in cfg and key in cfg["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert entry["name"] in used
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_limits_set():
    from gpubench import check

    for entry in BENCH["configs"]:
        lim = manifest.load_config(entry["name"])["limits"]
        for name, v in lim.items():
            assert name not in check.EXACT and v > 0


def test_run_seconds_budget():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_lookup_by_name_refuses_paths():
    with pytest.raises(ValueError):
        manifest.load_config("../BENCHMARK")
    with pytest.raises(KeyError):
        manifest.cell(BENCH, "no_such_cell")
