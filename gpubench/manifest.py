"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``, a ``read(run)`` function); a world's generator
(``worlds/<generator>.py``, found by ``world.py``) is found the same way.

A configuration's ``map`` and ``em`` groups are the program's
``MapConfig`` and ``EMConfig`` under their own field names; a mix may hold
groups of the same names, which override the configuration's key by key
(``settings``), so a cell that changes a program setting is data alone."""

from __future__ import annotations

import copy
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{_name(kind, name)}.json"
    with open(path) as fh:
        return json.load(fh)


def load_config(name: str, root: Path = HERE) -> dict:
    return load_json("configs", name, root)


def load_mix(name: str, root: Path = HERE) -> dict:
    return load_json("traffic", name, root)


def settings(bench: dict, workload: str, root: Path = HERE):
    """(configuration, mix) of a cell, the configuration's ``map`` and
    ``em`` groups updated by the mix's."""
    w = cell(bench, workload)
    cfg = copy.deepcopy(load_config(w["config"], root))
    mix = load_mix(w["traffic"], root)
    for group in ("map", "em"):
        cfg[group].update(mix.get(group, {}))
    return cfg, mix


def load_module(folder: str, kind: str, name: str, root: Path = HERE):
    """The module ``<folder>/<name>.py`` under ``root``; ValueError where
    ``name`` is no name or names no such file."""
    path = root / folder / f"{_name(kind, name)}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} named {name!r}: {folder}/{name}.py "
                         "is missing")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{folder}_" + re.sub(r"[.-]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    # registered as an import would be: a dataclass looks its module up
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module("metrics", "metric", name, root).read


def metrics_for(bench: dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced; each only where its
    ``workloads`` (if any) lists the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]
