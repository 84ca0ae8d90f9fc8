"""One run of one benchmark cell:

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Load the program (``seekmer_tpu_torch``) and the cell's world and
   index (made and cached in ``gpubench/.cache`` on a checkout's first
   run; the index by the program's own ``index`` command).
2. Make the cell's sample from ``--seed`` and write it as FASTQ lanes
   into a directory of its own under ``$TMPDIR`` (which must be set),
   removed at the end.
3. Warm up on one sample (two for a pack-cache mix: the first builds the
   cache, as a user's first run does).
4. Quantify the sample back to back for ``--seconds``, one operator on
   one card: ``Quantifier.quantify_files``, the call ``infer`` makes, then
   the outputs written as ``infer`` writes them; the next sample starts
   when the last is written, and a sample started in the window is waited
   for and counted.
5. Hold every sample's outputs against the plain reference (``check.py``)
   once the window has closed, the peak memory has been read and the
   program's state is freed.
6. Print one JSON line last: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the end-to-end metrics; with ``--trace 1`` the per-layer
   ones, read from a ``torch.profiler`` trace of the whole window),
   ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each
   number compared, with its limit).

``setup_s`` runs from process start to the end of the warm-up, less the
benchmark's own making of the world, the reference's table and the
sample, which the log gives on earlier lines. The run exits non-zero with
no result where no card is found, and where ``jax``, ``jaxlib``, ``flax``
or ``seekmer_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_T_IMPORT = time.monotonic()

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "seekmer_tpu")


class NoCard(RuntimeError):
    pass


def process_age() -> float:
    """Seconds since this process started (10 ms grain), from /proc; the
    time since this module was imported where /proc is absent."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def pipeline_config(cfg: dict, seed: int):
    """The program's settings: the cell's ``map`` and ``em`` groups
    (``manifest.settings``) as ``MapConfig`` and ``EMConfig``, whose own
    field names they use, so an unknown key raises; the bootstrap's seed
    from ``--seed``."""
    from seekmer_tpu_torch.config import EMConfig, MapConfig, PipelineConfig

    return PipelineConfig().replace(
        map=MapConfig(**cfg["map"]),
        em=EMConfig(**cfg["em"], bootstrap_seed=seed % (1 << 63)))


def write_outputs(out_dir: Path, index, res, cmd: str) -> None:
    """The files ``infer`` writes, as it writes them."""
    from seekmer_tpu_torch.io.writer import (write_abundance, write_bootstrap,
                                             write_gene_abundance, write_h5,
                                             write_run_info)

    out_dir.mkdir(parents=True, exist_ok=True)
    write_abundance(str(out_dir / "abundance.tsv"), res.names, res.lengths,
                    res.eff_length, res.est_counts, res.tpm)
    write_h5(str(out_dir / "abundance.h5"), res.names, res.lengths,
             res.eff_length, res.est_counts, boot_counts=res.bootstrap_counts,
             run_info={"total_reads": res.total_reads, "call": cmd,
                       "start_time": time.strftime("%Y-%m-%dT%H:%M:%S")})
    if res.bootstrap_counts is not None:
        write_bootstrap(str(out_dir / "bootstrap.npz"), res.names,
                        res.bootstrap_counts)
    if index.genes is not None:
        write_gene_abundance(str(out_dir / "abundance.genes.tsv"),
                             index.genes, res.est_counts, res.tpm)
    write_run_info(str(out_dir / "run_info.json"), {
        "total_reads": res.total_reads, "mapped": res.mapped,
        "unmapped": res.unmapped, "em_iterations": res.em_iterations,
        "log_likelihood": res.log_likelihood,
        "fld": (None if res.fld_mean is None else
                {"mean": res.fld_mean, "sd": res.fld_sd,
                 "samples": res.fld_samples}),
        "timings": res.timings, "n_targets": int(index.num_transcripts)})


def count_rows(path: Path) -> int:
    """Data rows of a written abundance.tsv (its header line left out)."""
    with open(path, "rb") as fh:
        return max(sum(1 for _ in fh) - 1, 0)


class Run:
    """What the per-layer readers (``metrics/*.py``) read."""

    def __init__(self):
        self.samples = []  # per sample: its QuantResult.timings
        self.fragments = 0  # fragments a sample
        self.window_s = 0.0
        self.index_load_s = None
        self.trace = None  # trace.reduce_events(...) of the window
        self.k2_bound_s = None  # K2's least seconds a sample
        self.a3_bound_s = None  # A3's least seconds over the window
        self.baseline_fragments_per_s = None

    def per_sample(self, key: str):
        """The mean of timing ``key`` over the window's samples; None
        where a sample lacks it."""
        if not self.samples or any(key not in s for s in self.samples):
            return None
        return sum(s[key] for s in self.samples) / len(self.samples)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: Path = HERE,
             cache: Path = CACHE, tmp: Path = None, log=None):
    """One run; returns the result dict (``correct`` ... ``checks``). The
    sample and the outputs go into a directory of their own under ``tmp``
    (``$TMPDIR`` by default, which must then be set), removed at the end."""
    import torch

    from . import manifest

    w_cell = manifest.cell(bench, workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device")
        if torch.cuda.device_count() < w_cell["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} CUDA devices; the "
                         f"cell asks for {w_cell['chips']}")
    tmp = tmp or os.environ.get("TMPDIR")
    if not tmp:
        raise RuntimeError("TMPDIR is not set: the sample's FASTQ and the "
                           "outputs go under it")
    sdir = Path(tempfile.mkdtemp(prefix="gpubench-", dir=tmp))
    try:
        return _run_cell(bench, workload, seed, seconds, trace, device, root,
                         cache, sdir,
                         log or (lambda m: print(m, file=sys.stderr,
                                                 flush=True)))
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def _run_cell(bench, workload, seed, seconds, trace, device, root, cache,
              sdir, log):
    import numpy as np
    import torch

    from . import check, manifest, simulate, world
    from . import trace as tr
    from .yardstick import baseline, bounds

    cfg, mix = manifest.settings(bench, workload, root)
    dev = torch.device(device)
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[run] {workload} seed {seed} seconds {seconds} trace {int(trace)} "
        f"card {card}")

    excluded = 0.0
    wd = world.ensure(cfg, cache, dev, log)
    excluded += wd.made_s

    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.models.quantifier import Quantifier

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    run = Run()
    t0 = time.perf_counter()
    index = KMerIndex.load(str(wd.index))
    run.index_load_s = time.perf_counter() - t0
    log(f"[setup] index load {run.index_load_s:.6f} s "
        f"({index.num_transcripts} transcripts, {index.num_kmers} k-mers)")

    t0 = time.perf_counter()
    rd = cfg["reads"]
    paired = bool(cfg["map"]["paired_end"])
    lanes1, lanes2 = world.sample(wd, cfg, mix, seed)
    r1, r2, nbytes = [], [], 0
    for i in range(mix["lanes"]):
        r1.append(sdir / f"lane{i}_1.fq")
        nbytes += simulate.write_fastq(str(r1[-1]), lanes1[i])
        if paired:
            r2.append(sdir / f"lane{i}_2.fq")
            nbytes += simulate.write_fastq(str(r2[-1]), lanes2[i])
    made = time.perf_counter() - t0
    excluded += made
    N = mix["lanes"] * mix["fragments_per_lane"]
    run.fragments = N
    log(f"[sample] {N} fragments in {mix['lanes']} lanes, {nbytes} bytes "
        f"of FASTQ, made in {made:.6f} s (not set-up)")

    pack = None
    if mix["input"] == "pack_cache":
        pack = str(sdir / "pack_cache")
    elif mix["input"] != "fastq":
        raise ValueError(f"unknown input {mix['input']!r}")
    q = Quantifier(index, pipeline_config(cfg, seed), device=dev)
    outs_root = sdir / "out"
    cmd = f"gpubench {workload} seed {seed}"

    def sample(out_dir: Path):
        with torch.profiler.record_function("gpubench.sample"):
            res = q.quantify_files([str(p) for p in r1],
                                   mate_paths=[str(p) for p in r2] or None,
                                   pack_cache=pack)
            with torch.profiler.record_function("gpubench.write"):
                write_outputs(out_dir, index, res, cmd)
        return res

    for i in range(2 if pack else 1):
        sample(outs_root / f"warm{i}")
    sync()
    setup_s = process_age() - excluded
    log(f"[setup] setup_s {setup_s:.6f} (process age less {excluded:.6f} s "
        f"of the benchmark's own making)")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outs = []
    with tr.profiled() if trace else contextlib.nullcontext() as prof:
        t_start = time.perf_counter()
        t_end = t_start
        while t_end - t_start < seconds:
            i = len(outs)
            res = sample(outs_root / f"s{i}")
            t_end = time.perf_counter()
            run.samples.append(dict(res.timings))
            outs.append({"total": res.total_reads, "mapped": res.mapped,
                         "est": res.est_counts, "iters": res.em_iterations,
                         "boot": res.bootstrap_counts,
                         "fld": (None if res.fld_mean is None else
                                 (res.fld_mean, res.fld_sd, res.fld_samples)),
                         "dir": outs_root / f"s{i}"})
        sync()
    run.window_s = t_end - t_start
    rate = len(outs) * N / run.window_s
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    log(f"[window] {len(outs)} samples in {run.window_s:.6f} s: "
        f"{rate:.6f} fragments/s; peak device memory {peak} bytes")
    for i, t in enumerate(run.samples):
        log(f"[window] sample {i}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(t.items())
            if isinstance(v, float)))
    for o in outs:
        o["rows"] = count_rows(o["dir"] / "abundance.tsv")

    geometry = (index.main_slots // index.bucket, index.bucket)
    if trace:
        red = tr.reduce_events(prof.events())
        run.trace = red
        del prof
        log(f"[trace] device busy {red['busy_s']:.6f} s of "
            f"{red['window_s']:.6f} s traced")
        first = lanes1[0][:131072]
        rows = (np.concatenate([first, lanes2[0][:131072]]) if paired
                else first)
        run.baseline_fragments_per_s, rates = baseline.dense_rate(
            index, rows, first.shape[0], cache / "build")
        log(f"[baseline] dense arm, {first.shape[0]} fragments "
            f"({rows.shape[0]} rows): best {run.baseline_fragments_per_s:.3f}"
            f" fragments/s of " + ", ".join(f"{r:.3f}" for r in rates))

    # free the program's state before the reference runs
    del q, index, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    table = world.load_table(wd, dev)
    to = lambda a: torch.from_numpy(a)  # noqa: E731
    ref = check.Reference(table, [to(a) for a in lanes1],
                          [to(a) for a in lanes2] if paired else None,
                          wd.lengths, cfg, dev)
    limits = cfg.get("limits", {})
    worst, failed = check.judge(outs, ref, limits)
    unset = check.any_unset(worst, limits)
    log(f"[check] reference: {ref.total} fragments, {ref.mapped} mapped, "
        f"{ref.ecs.E} classes, nnz {ref.ecs.txp.numel()}, fld "
        f"{ref.fld}; the program's (mean, sd, n) "
        f"{sorted({o['fld'] for o in outs if o['fld']})}; "
        f"{time.perf_counter() - t0:.3f} s")

    if trace:
        k = cfg["index"]["kmer_length"]
        run.k2_bound_s = k2_bound(table, lanes1, lanes2 if paired else None,
                                  k, cfg["map"]["batch_size"], geometry,
                                  rd["read_len"])
        E, T, nnz = ref.ecs.E, ref.T, ref.ecs.txp.numel()
        B = cfg["em"]["bootstrap_samples"]
        C = cfg["em"]["check_every"]
        run.a3_bound_s = sum(
            bounds.a3_seconds(E, T, nnz, 1, int(t.get("em_iterations", 0)), C)
            + bounds.a3_seconds(E, T, nnz, B,
                                int(t.get("bootstrap_iterations", 0)), C)
            for t in run.samples)
    metrics = read_metrics(bench, workload, trace, run,
                           {"fragments_per_s": rate, "setup_s": setup_s},
                           root, log)

    result = {"correct": failed == 0 and unset is None and len(outs) > 0,
              "attempted": len(outs), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)},
              "card": card}
    if trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = tr.breakdown(run.trace)
    if unset is not None:
        log(f"[check] no limit set for {unset}")
    result["checks"] = check.check_lines(worst, limits)
    return result


def read_metrics(bench: dict, workload: str, trace: bool, run: Run,
                 end_to_end: dict, root: Path, log) -> dict:
    """The line's metrics: untraced the cell's end-to-end ones, the
    values ``end_to_end`` gives by name; traced its per-layer ones, each
    from its reader over ``run``. A reader that finds nothing to read
    (None, or a value that is not finite) is logged and its metric left
    out, so a reader of a span that the program under test lacks reads
    nothing there rather than failing the run."""
    from . import manifest

    metrics = {}
    for m in manifest.metrics_for(bench, workload, trace):
        if not trace:
            v = end_to_end[m["name"]]
        else:
            v = manifest.metric_reader(m["name"], root)(run)
            if v is None or not math.isfinite(v):
                log(f"[metric] {m['name']} found nothing to read in "
                    f"{workload} ({v}): left out")
                continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics


def k2_bound(table, lanes1, lanes2, k: int, batch: int, geometry,
             read_len: int) -> float:
    """K2's least seconds for one sample (mates ``lanes2``, None for
    single-end reads): the sample cut into batches of ``batch`` fragments,
    each counted by ``bounds.k2_bytes`` against the table's (buckets,
    slots a bucket) ``geometry``."""
    import torch

    from .reference import kmers
    from .yardstick import bounds

    dev = table["keys"].device
    mates = 2 if lanes2 is not None else 1
    total = 0.0
    for li, lane in enumerate(lanes1):
        for s in range(0, lane.shape[0], batch):
            keys, found = [], []
            for codes in ([lane] + ([lanes2[li]] if mates == 2 else [])):
                kk, v = kmers.windows(torch.from_numpy(
                    codes[s:s + batch]).to(dev), k)
                keys.append(kk[v])
                found.append(kk[kmers.lookup(table, kk, v) >= 0])
            dv = torch.unique(torch.cat(keys)).numel()
            df = torch.unique(torch.cat(found)).numel()
            total += bounds.k2_seconds(bounds.k2_bytes(
                min(batch, lane.shape[0] - s), mates, read_len, k, dv, df,
                *geometry))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import logging

    logging.basicConfig(level=logging.WARNING,
                        format="[%(levelname)s %(name)s] %(message)s")
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    from . import manifest

    try:
        result = run_cell(manifest.load_benchmark(), args.workload,
                          args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"[run] {e}: no result", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"[run] loaded in this process: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
