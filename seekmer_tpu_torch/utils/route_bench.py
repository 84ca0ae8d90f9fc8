"""R1 and R2 of one or more checkouts of the port in turns, on synthetic
lanes shaped as a rank's half of a paired config-2 batch (6,815,744
lanes, 73% of them valid as in config 2), one round at capacity factor 2,
at 2 and 4 owners.

    python -m seekmer_tpu_torch.utils.route_bench A [B ...] [--rounds 2]

Each checkout runs in a process of its own that imports the port from it
and times it with this file's timers. Besides R1 and R2 as
``routed_lookup`` calls them, R2 is timed with each owner's run sorted by
lane (where a warp's stores land), with every count 0 (its grid alone),
on an ``ecs`` filled afresh before each call (as ``routed_lookup`` fills
it), and on lanes that are all valid (every sector of ``ecs`` written
whole). R2's result is checked against the lanes' own ECs. Device ms with
the card kept busy (``kernel_ab.device_ms``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N = 6_815_744  # a rank's half of a config-2 batch: 32,768 pairs x 208
VALID = 0.73  # config 2's share of valid windows


def _child() -> None:
    import numpy as np
    import torch

    from seekmer_tpu_torch.ops import route_cuda
    from seekmer_tpu_torch.utils.kernel_ab import device_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(0)
    hi = torch.randint(0, 1 << 26, (N,), generator=g, dtype=torch.int32)
    lo = torch.randint(0, 1 << 24, (N,), generator=g, dtype=torch.int32)
    some = torch.rand(N, generator=g) < VALID
    hi, lo, some = hi.to(dev), lo.to(dev), some.to(dev)
    out = {}
    for tag, valid in (("", some), ("all_valid_", torch.ones_like(some))):
        for D in (2, 4):
            K = int(np.ceil(N / D * 2.0))  # prefix_shard.capacity
            s_hi, s_lo, ret, counts, _ = route_cuda.route_first(hi, lo, valid,
                                                                D, K)
            back = (s_hi ^ s_lo) & 0xFFFF
            ecs = torch.full((N,), -1, dtype=torch.int32, device=dev)
            route_cuda.unroute(back, ret, counts, 0, K, ecs)
            if not torch.equal(ecs, torch.where(valid, (hi ^ lo) & 0xFFFF,
                                                -1)):
                raise AssertionError(f"R2 at D = {D} put a wrong EC")
            r = {"R2_ms": device_ms(lambda: route_cuda.unroute(
                back, ret, counts, 0, K, ecs), 100)}
            if not tag:
                r["R1_ms"] = device_ms(lambda: route_cuda.route_first(
                    hi, lo, valid, D, K), 100)
                srt = ret.clone()
                for d in range(D):
                    run = slice(d * K, d * K + int(counts[d]))
                    srt[run] = torch.sort(ret[run]).values
                r["R2_sorted_ms"] = device_ms(lambda: route_cuda.unroute(
                    back, srt, counts, 0, K, ecs), 100)
                none = torch.zeros_like(counts)
                r["R2_empty_ms"] = device_ms(lambda: route_cuda.unroute(
                    back, ret, none, 0, K, ecs), 100)
                r["R2_fresh_ms"] = device_ms(
                    lambda e: route_cuda.unroute(back, ret, counts, 0, K, e),
                    100, lambda: torch.full((N,), -1, dtype=torch.int32,
                                            device=dev))
            out[f"{tag}D{D}"] = r
    print(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        _child()
        return 0
    sides = [os.path.abspath(c) for c in args.checkouts]
    for r in range(args.rounds):
        for side in (sides if r % 2 == 0 else sides[::-1]):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child"], cwd=side, capture_output=True,
                               text=True, env=dict(os.environ,
                                                   PYTHONPATH=side))
            if p.returncode:
                raise RuntimeError(f"the timers failed on {side}:\n"
                                   f"{p.stderr[-4000:]}")
            print(f"round {r} {side}: {p.stdout.strip().splitlines()[-1]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
