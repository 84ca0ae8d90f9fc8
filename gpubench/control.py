"""The control of ``correct``: the reference put in the program's place and
computed in the precision below the one the configuration states
(bfloat16 for its float32 EM), on a cell's own sample at the cell's own
size. Its numbers (``check.numbers``) set the upper end of each limit: a
sound limit passes the program and fails this.

With ``--fault`` the reference stays in float64 and carries one planted
fault of the bootstrap instead, whose numbers bound the bootstrap's
limits: ``no_resample`` (every replicate EM on the sample's own counts,
so the point estimate a hundred times) or ``boot_short`` (each
replicate's EM stopped after its first block of ``check_every`` steps,
as a loop that skipped its stopping test would stop).

    python -m gpubench.control --workload <cell> --seeds <n> [<n> ...]
        [--fault no_resample|boot_short]

prints, for each seed, one line ``control <seed> {numbers}`` (``fault
<name> <seed> {numbers}`` with ``--fault``). The benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import check, manifest, world
from .reference import em as ref_em

HERE = Path(__file__).resolve().parent


FAULTS = ("no_resample", "boot_short")


def control_outputs(ref: check.Reference, bootstrap: int, seed: int,
                    dtype=torch.bfloat16, fault: str = None) -> dict:
    """What the program would output if it were the reference computed in
    ``dtype``: the fragment-length estimate, EM to its own stopping rule
    and ``bootstrap`` replicates of EM on multinomial resamples of the
    class counts, all in ``dtype``; mapping is integer work and exact.
    With a ``fault`` (one of ``FAULTS``) the bootstrap carries it."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    em = ref.cfg["em"]
    fld = (ref_em.fld_estimate(ref.fld_hist, dtype=dtype)
           if em["estimate_fld"] else None)
    mean, sd = ((fld[0], fld[1]) if fld is not None
                else (em["mean_fragment_length"], em["fragment_length_sd"]))
    eff = ref_em.effective_lengths(ref.lengths, mean, sd, dtype=dtype)
    theta, it, _ = ref_em.run(ref.ecs, ref.ec_counts, eff, em, dtype=dtype)
    gen = torch.Generator(device=ref.device)
    gen.manual_seed(seed % (1 << 63))
    p = ref.ec_counts.to(torch.float64)
    N = int(ref.ec_counts.sum())
    if fault == "no_resample":
        cm = ref.ec_counts[:, None].expand(-1, bootstrap)
    else:
        cm = torch.stack([torch.bincount(
            torch.multinomial(p, N, replacement=True, generator=gen),
            minlength=ref.ecs.E) for _ in range(bootstrap)], dim=1)
    boot, _, _ = ref_em.run(ref.ecs, cm, eff, em, dtype=dtype,
                            iters=(em["check_every"] if fault == "boot_short"
                                   else None))
    return {"total": ref.total, "mapped": ref.mapped,
            "est": theta.float().cpu().numpy(), "iters": it,
            "boot": boot.t().float().cpu().numpy(), "fld": fld,
            "rows": ref.T}


def run_control(bench: dict, workload: str, seeds, device="cuda",
                root: Path = HERE, cache: Path = HERE / ".cache",
                dtype=torch.bfloat16, log=print, fault: str = None):
    """Each seed's control numbers (with a ``fault``, the float64
    reference's with that fault), as a list of dicts."""
    cfg, mix = manifest.settings(bench, workload, root)
    if fault is not None:
        dtype = torch.float64
    dev = torch.device(device)
    wd = world.ensure(cfg, cache, dev, log)
    table = world.load_table(wd, dev)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        l1, l2 = world.sample(wd, cfg, mix, seed)
        ref = check.Reference(
            table, [torch.from_numpy(a) for a in l1],
            ([torch.from_numpy(a) for a in l2]
             if cfg["map"]["paired_end"] else None),
            wd.lengths, cfg, dev)
        nums = check.numbers(control_outputs(
            ref, cfg["em"]["bootstrap_samples"], seed, dtype, fault), ref)
        log(f"{'control' if fault is None else 'fault ' + fault} {seed} "
            f"{json.dumps(nums)} "
            f"({time.perf_counter() - t0:.1f} s)")
        out.append(nums)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)
    run_control(manifest.load_benchmark(), args.workload, args.seeds,
                log=lambda m: print(m, flush=True), fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
