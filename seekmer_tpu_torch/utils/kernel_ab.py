"""Timers for K3 (signatures), A1 (accumulate), K5 and K6 (fast mode's
sample and merge), K7 (strided lookup), R1 (routing) and A4 (per-EC sums)
on one card, and the same timings of two checkouts of the port in turns.

    python -m seekmer_tpu_torch.utils.kernel_ab INPUTS A B [--rounds 3]
        [--k7-segs 4,7,14]

INPUTS is a file of one batch's K3 inputs (``ecs`` int32 [B, P], ``valid``
bool [B, P], ``max_ecs`` and the index's ``num_ecs``) and, under ``fast``,
the batch's mates and the index's device tables, as ``chip_smoke.py
--keep-inputs INPUTS`` writes them for a paired config-2 batch. A and B
are checkouts of the repository, for example a parent commit and a change
unpacked with ``git archive``. Each round runs
A and B, which one first alternating, each in a process of its own that
imports the port from its checkout and times that checkout's kernels with
the timers below (this file's, whichever side is timed), on the same
inputs: K3, then A1 on the signatures K3 made, then K5 at strides 16 and
8 and K6 on what the checkout's own K5, K1, K2 and K3 make at 16, then,
where the checkout has them, K7 at strides 16, 8, 4 and 2 and K3 with
``segments=2`` on the batch's windows packed by K1, then, where INPUTS
holds them (``route``: a rank's half of the batch at 2 owners), R1's
one-round call at capacity factor 2 in the checkout's form (its one
entry, or an earlier checkout's rank entry plus one dispatch), and, where
INPUTS.a4.pt exists (config 2's EC table and terms), A4's whole call
and an empty launch of its grid. ``--k7-segs`` also
times K7 under tiles of each of those sizes of segments, where the
checkout's plan has a carve (``strided_cuda._carve``) and it fits a warp's
share of shared memory at 4 blocks an SM, each checked bit for bit against
the checkout's own plan. Needs a CUDA card.

Device times are taken with the card kept busy while the host enqueues the
call (``torch.cuda._sleep`` before the start event), so they hold the
kernel's device time and not the wrapper's host time; the host time of a
call is timed apart, on the host clock without a synchronise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SIG_PAD = 0x7FFFFFFF
SLEEP_CYCLES = 400_000  # ~0.2 ms at the H100's clock: longer than any enqueue


def device_ms(fn, reps: int, setup=None) -> float:
    """Mean device ms of ``fn(setup())`` (or ``fn()``), one call a reading,
    with ``setup`` outside the timed span."""
    import torch

    fn(setup()) if setup else fn()
    spans = []
    for _ in range(reps):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(arg) if setup else fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds a call takes to return (the enqueue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e6


def head_counts(ecs, valid):
    """Run heads a read, as K3 counts them: windows that are neither
    missed nor invalid and differ from the window before."""
    import torch

    x = torch.where(valid & (ecs >= 0), ecs, SIG_PAD)
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    return ((x != SIG_PAD) & (x != prev)).sum(dim=1)


def head_summary(ecs, valid) -> dict:
    h = head_counts(ecs, valid)
    return {"reads": int(h.numel()),
            "share_le_32": float((h <= 32).float().mean()),
            "max": int(h.max()) if h.numel() else 0,
            "mean": float(h.float().mean()) if h.numel() else 0.0}


def time_k3(ecs, valid, C: int, reps: int = 50) -> dict:
    from seekmer_tpu_torch.ops import sig_cuda

    return {"ms": device_ms(lambda: sig_cuda.read_signatures(ecs, valid, C),
                            reps),
            "host_us": host_us(lambda: sig_cuda.read_signatures(ecs, valid,
                                                                C), reps)}


def time_a1(sig, mapped, weights, num_ecs: int, bits: int = 22,
            reps: int = 20) -> dict:
    """A1 on one batch: claim alone and claim plus audit on an empty table
    (made outside the timed span), both again in steady state (the batch
    already in the table: every multi-EC read matches), the host enqueue of
    a call, and, where the checkout has it, the empty launch of the same
    grid, plain and cooperative. Device ms, host us."""
    import torch

    from seekmer_tpu_torch.map.signature import make_sig_table
    from seekmer_tpu_torch.ops import accumulate_cuda

    C = sig.shape[1]

    def fresh():
        return make_sig_table(bits, C, num_ecs=num_ecs, device=sig.device)

    def fold(t, audit):
        accumulate_cuda.fold_batch(t, sig, mapped, weights=weights,
                                   audit=audit)

    out = {
        "claim_ms": device_ms(lambda t: fold(t, False), reps, fresh),
        "claim_audit_ms": device_ms(lambda t: fold(t, True), reps, fresh),
    }
    table = fresh()
    fold(table, True)
    out["steady_claim_ms"] = device_ms(lambda: fold(table, False), reps)
    out["steady_claim_audit_ms"] = device_ms(lambda: fold(table, True), reps)
    # the same steady claim with only the single-EC reads weighted (their
    # direct-vector atomicAdds) and with only the multi-EC reads
    w = (torch.ones(sig.shape[0], dtype=torch.int32, device=sig.device)
         if weights is None else weights)
    single = (sig[:, 0] != SIG_PAD) & (sig[:, 1] == SIG_PAD)
    for tag, part in (("singles", single), ("multi", ~single)):
        wp = torch.where(part, w, 0)
        out[f"steady_{tag}_only_ms"] = device_ms(
            lambda: accumulate_cuda.fold_batch(table, sig, mapped, weights=wp,
                                               audit=False), reps)
    out["host_us"] = host_us(lambda: fold(table, True), reps)
    out["host_us_no_audit"] = host_us(lambda: fold(table, False), reps)
    if hasattr(accumulate_cuda, "empty_launch"):
        B = sig.shape[0]
        for coop in (False, True):
            out["floor_coop_ms" if coop else "floor_ms"] = device_ms(
                lambda: accumulate_cuda.empty_launch(B, sig.device, coop),
                reps)
    return out


def time_fast(fast: dict, dev, reps: int = 50) -> dict:
    """K5 (no readback) at each of ``fast["strides"]`` and K6 on the merge
    inputs of the first stride (K5, then K1, K2 and K3 on its units, this
    checkout's kernels all), on one batch's mates and index tables. Device
    ms. (K6's grid, 256 reads a block, is A1's: ``time_a1``'s
    ``floor_ms`` is its empty launch.)"""
    from seekmer_tpu_torch.ops import fast_cuda, pack_cuda, probe_cuda, \
        sig_cuda

    mates = [tuple(t.to(dev) for t in m) for m in fast["mates"]]
    geo = (fast["table"].to(dev), fast["main_slots"], fast["stash"].to(dev),
           fast["stash_slots"], fast["bucket"])
    L, k, C = fast["L"], fast["k"], fast["max_ecs"]
    out = {}
    for s in fast["strides"]:
        out[f"K5_s{s}_ms"] = device_ms(
            lambda: fast_cuda.launch_sample(mates, L, k, s, *geo), reps)
    single, slot, units = fast_cuda.sample_classify(mates, L, k,
                                                    fast["strides"][0], *geo)
    hi, lo, valid = pack_cuda.pack_canonical_2bit(*units, L, k)
    sig_d, mapped_d = sig_cuda.read_signatures(
        probe_cuda.lookup_ecs(hi, lo, valid, *geo), valid, C)
    out["K6_ms"] = device_ms(lambda: fast_cuda.merge_staging(
        single, slot, sig_d, mapped_d, C), reps)
    return out


def time_k7(fast: dict, dev, strides=(16, 8, 4, 2), reps: int = 50,
            segs=()) -> dict:
    """K7 (strided lookup) on the batch's windows, both mates packed by K1
    into one (B, 2P) row as the map step packs them, each mate a segment,
    under the checkout's plan and under tiles of each size in ``segs``
    (where they fit: the module's ``strided_plan`` replaced while timed),
    and K3 with ``segments=2`` on K2's result for those windows (fusion
    mode's signatures). Device ms; empty where the checkout has no K7."""
    import torch

    from seekmer_tpu_torch.ops import pack_cuda, probe_cuda, sig_cuda
    try:
        from seekmer_tpu_torch.ops import strided_cuda
    except ImportError:
        return {}
    mates = [tuple(t.to(dev) for t in m) for m in fast["mates"]]
    geo = (fast["table"].to(dev), fast["main_slots"], fast["stash"].to(dev),
           fast["stash_slots"], fast["bucket"])
    L, k, C = fast["L"], fast["k"], fast["max_ecs"]
    B, P = mates[0][0].shape[0], L - k + 1
    out = tuple(torch.empty((B, 2 * P), dtype=dt, device=dev)
                for dt in (torch.int32, torch.int32, torch.bool))
    for i, m in enumerate(mates):
        pack_cuda.pack_canonical_2bit(*m, L, k, out=out, offset=i * P)
    hi, lo, valid = out
    res = {}
    own = strided_cuda.strided_plan
    for s in strides:
        def call(s=s):
            return strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, s,
                                                   segments=2)

        res[f"K7_s{s}_ms"] = device_ms(call, reps)
        if not hasattr(strided_cuda, "_carve"):
            continue
        ref, S = call(), -(-P // s) + 1
        for n in segs:
            if (strided_cuda._carve(P, S, n)[-1]
                    > strided_cuda.warp_budget(strided_cuda.MIN_BLOCKS)):
                continue
            strided_cuda.strided_plan = lambda *a, n=n: (
                strided_cuda.StridedPlan(S, n, strided_cuda.MIN_BLOCKS,
                                         *strided_cuda._carve(P, S, n)))
            try:
                if not torch.equal(call(), ref):
                    raise AssertionError(f"K7 at s={s} under tiles of {n} "
                                         f"segments differs from its plan")
                res[f"K7_s{s}_segs{n}_ms"] = device_ms(call, reps)
            finally:
                strided_cuda.strided_plan = own
    ecs = probe_cuda.lookup_ecs(hi, lo, valid, *geo)
    res["K3_segments2_ms"] = device_ms(
        lambda: sig_cuda.read_signatures(ecs, valid, C, segments=2), reps)
    return res


def time_route(r: dict, dev, reps: int = 50) -> dict:
    """R1 at capacity factor 2 on a rank's lanes, one round, in whichever
    form the checkout has: ``route_first`` (rank and round 0's slab in
    one pass) or ``route_rank`` + one ``dispatch``. Device ms. The second
    form is there only to time a checkout from before ``route_first``;
    drop it once no A/B run compares such a checkout."""
    from seekmer_tpu_torch.ops import route_cuda

    hi, lo, valid = (r[k].to(dev).reshape(-1) for k in ("hi", "lo", "valid"))
    D = r["D"]
    K = int(np.ceil(hi.numel() / D * 2.0))  # prefix_shard.capacity
    if hasattr(route_cuda, "route_first"):
        def call():
            return route_cuda.route_first(hi, lo, valid, D, K)
    else:
        def call():
            o, rk, _ = route_cuda.route_rank(hi, lo, valid, D)
            return route_cuda.dispatch(hi, lo, o, rk, D, 0, K)
    return {"R1_ms": device_ms(call, reps)}


def time_a4(a4: dict, dev, reps: int = 50) -> dict:
    """A4's whole call on config 2's EC table, and an empty launch of its
    grid (a thread an nnz entry, 256 a block: A1's grid for nnz reads).
    Device ms."""
    from seekmer_tpu_torch.ops import accumulate_cuda, em_csr_cuda

    w, ids, E = a4["w"].to(dev), a4["ec_ids"].to(dev), a4["E"]
    return {"A4_ms": device_ms(lambda: em_csr_cuda.ec_sums(w, ids, E), reps),
            "floor_ms": device_ms(lambda: accumulate_cuda.empty_launch(
                w.numel(), dev, False), reps)}


def _child(inputs: str, k7_segs=()) -> None:
    import torch

    from seekmer_tpu_torch.ops import sig_cuda

    data = torch.load(inputs)
    dev = torch.device("cuda", torch.cuda.current_device())
    ecs, valid = data["ecs"].to(dev), data["valid"].to(dev)
    C = data["max_ecs"]
    sig, mapped = sig_cuda.read_signatures(ecs, valid, C)
    weights = torch.ones(sig.shape[0], dtype=torch.int32, device=dev)
    out = {"K3": time_k3(ecs, valid, C),
           "A1": time_a1(sig, mapped, weights, data["num_ecs"])}
    if "fast" in data:
        out["fast"] = time_fast(data["fast"], dev)
        out["strided"] = time_k7(data["fast"], dev, segs=k7_segs)
    if "route" in data:
        out["R1"] = time_route(data["route"], dev)
    if os.path.exists(f"{inputs}.a4.pt"):
        out["A4"] = time_a4(torch.load(f"{inputs}.a4.pt"), dev)
    print(json.dumps(out))


def run_side(checkout: str, inputs: str, k7_segs: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        inputs, "--k7-segs", k7_segs], cwd=checkout, env=env,
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"the timers failed on {checkout}:\n"
                           f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs")
    ap.add_argument("a", nargs="?")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k7-segs", default="",
                    help="comma-separated tile sizes to time K7 under too")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        _child(args.inputs, [int(x) for x in args.k7_segs.split(",") if x])
        return 0
    inputs = os.path.abspath(args.inputs)
    sides = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    readings = {}
    for r in range(args.rounds):
        for side in ("AB" if r % 2 == 0 else "BA"):
            got = run_side(sides[side], inputs, args.k7_segs)
            print(f"round {r} {side} ({sides[side]}): {json.dumps(got)}",
                  flush=True)
            for k, rec in got.items():
                for m, v in rec.items():
                    readings.setdefault((k, m, side), []).append(v)
    for (k, m, side), vs in sorted(readings.items()):
        print(f"{side} {k} {m}: median {np.median(vs):.6f}, range "
              f"{min(vs):.6f} - {max(vs):.6f}, {len(vs)} readings",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
