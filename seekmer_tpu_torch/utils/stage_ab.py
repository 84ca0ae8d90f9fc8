"""Stage walls of two checkouts of the port, in turns, on one card.

    python -m seekmer_tpu_torch.utils.stage_ab WORLD A B [--rounds 5]
        [--reps 3]

WORLD is a directory holding the two worlds as ``chip_smoke.py`` writes
them (``c1.npz`` and ``c1.fq``; ``c2.npz``, ``c2_1.fq`` and ``c2_2.fq``).
A and B are checkouts of the repository, for example a parent commit and
a change unpacked with ``git archive``. Each round runs A and B, which one
first alternating from round to round, each in a process of its own that
imports the port from its checkout. A process times the stages of each
world as ``chip_smoke.py``'s profile phase does untraced: the map stage
(``Mapper.run`` over the prefetched batches of the world's reads, the
index upload left out as set-up), a fixed 480-iteration EM and a fixed
480-iteration 100-replicate bootstrap on the ECs that map run found; each
once to warm up, then ``reps`` times. These stages are bound by the host
or by launches, and their walls move from run to run, so one reading a
side says little: this prints every reading, then each side's median and
quartiles. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# runs in the checkout's own interpreter, against the checkout's port
_CHILD = r"""
import json, sys, time
import torch
from seekmer_tpu_torch import EMConfig, MapConfig
from seekmer_tpu_torch.em.bootstrap import run_bootstrap
from seekmer_tpu_torch.em.em import build_ec_table, run_em
from seekmer_tpu_torch.index.store import KMerIndex
from seekmer_tpu_torch.io.fastq import (batch_read_pairs_native,
                                        batch_reads_native)
from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
from seekmer_tpu_torch.utils.prefetch import device_put_batches, prefetch

world, reps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda")
fixed = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480)
boot = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480,
                bootstrap_samples=100, bootstrap_seed=1)


def walls(fn):
    out = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[1:]


out = {}
for tag, paired, bits in (("c1", False, 20), ("c2", True, 22)):
    index = KMerIndex.load(f"{world}/{tag}.npz")
    cfg = MapConfig(batch_size=65536, sig_table_bits=bits,
                    paired_end=paired)
    ms = []
    for _ in range(reps + 1):
        mapper = Mapper(index, cfg, device=dev)
        raw = (batch_read_pairs_native([f"{world}/c2_1.fq"],
                                       [f"{world}/c2_2.fq"], cfg)
               if paired else batch_reads_native([f"{world}/c1.fq"], cfg))
        batches = prefetch(device_put_batches(raw, dev), depth=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = mapper.run(batches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out[f"{tag} map"] = ms[1:]
    members, counts, _ = resolve_signatures(result, index)
    ec = build_ec_table(members, counts, index.num_transcripts, device=dev)
    out[f"{tag} em"] = walls(
        lambda: run_em(ec, index.lengths, fixed)[0].sum().item())
    out[f"{tag} bootstrap"] = walls(
        lambda: run_bootstrap(ec, index.lengths, boot)[0].sum().item())
print(json.dumps(out))
"""


def run_side(checkout: str, world: str, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    r = subprocess.run([sys.executable, "-c", _CHILD, world, str(reps)],
                       cwd=checkout, env=env, capture_output=True, text=True,
                       check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    world = os.path.abspath(args.world)
    sides = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    walls = {}
    for r in range(args.rounds):
        for side in ("AB" if r % 2 == 0 else "BA"):
            got = run_side(sides[side], world, args.reps)
            for tag, ms in got.items():
                walls.setdefault((side, tag), []).extend(ms)
            print(f"round {r} {side} ({sides[side]}): " + ", ".join(
                f"{tag} {' '.join(f'{m:.6f}' for m in ms)} ms"
                for tag, ms in got.items()), flush=True)
    for (side, tag), ms in sorted(walls.items(),
                                  key=lambda kv: (kv[0][1], kv[0][0])):
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"{side} {tag}: median {med:.6f} ms, quartiles "
              f"{q1:.6f} - {q3:.6f} ms, {len(ms)} readings", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
