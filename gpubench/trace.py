"""The traced window: a ``torch.profiler`` trace of the card and of every
host thread's named ranges, reduced to device busy time, device time by
operation, and idle gaps by the host range they fall in (the reduction of
``chip_smoke.py``'s ``device_busy``, copied).
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

# host ranges an idle gap is charged to, the innermost that holds it: the
# program's spans (``utils/metrics.Metrics.span``) and the benchmark's own
RANGES = ("mapper", "index_upload", "index_layout", "map", "map_wait",
          "fld", "finalize", "resolve", "ec_table", "em", "bootstrap",
          "resample", "collect", "ingest", "upload", "pack",
          "gpubench.sample", "gpubench.write")


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity of every thread; yields the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield prof


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_events(events) -> Dict:
    """Device busy seconds (the union of kernel, copy and memset
    intervals; host ranges the profiler mirrors onto the device's
    timeline are left out), device seconds and count by operation name,
    the traced window's seconds (first to last event of any kind), and
    idle seconds by the innermost host range the gap's middle falls in.
    ``events`` are the profiler's ``FunctionEvent``s."""
    from torch.autograd import DeviceType

    dev, host, lo, hi = [], [], float("inf"), float("-inf")
    per: Dict[str, List[float]] = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end  # us
        lo, hi = min(lo, a), max(hi, b)
        if e.device_type == DeviceType.CUDA:
            # a host range mirrored on the device's timeline is no work
            if getattr(e, "is_user_annotation", False) or e.name in RANGES:
                continue
            dev.append((a, b))
            s = per.setdefault(e.name, [0.0, 0])
            s[0] += (b - a) / 1e6
            s[1] += 1
        elif e.name in RANGES:
            host.append((a, b, e.name))
    busy = _union(dev)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    by_name: Dict[str, Tuple[List[float], List[float]]] = {}
    for a, b, n in sorted(host):
        st, en = by_name.setdefault(n, ([], []))
        st.append(a)
        en.append(b)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid, name, best = (a + b) / 2, "other", float("inf")
        for n, (st, en) in by_name.items():
            # the latest range of this name starting before mid (ranges of
            # one name do not nest on one thread; check the one before too)
            i = bisect.bisect_right(st, mid) - 1
            for j in (i, i - 1):
                if 0 <= j and en[j] >= mid and en[j] - st[j] < best:
                    name, best = n, en[j] - st[j]
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (hi - lo) / 1e6 if busy else 0.0,
            "per_op": {k: (v[0], int(v[1])) for k, v in per.items()},
            "idle": idle}


def device_seconds(red: Dict, fragment: str) -> Tuple[float, int]:
    """Summed device seconds and launches of the kernels whose name holds
    ``fragment``."""
    s, n = 0.0, 0
    for name, (sec, cnt) in red["per_op"].items():
        if fragment in name:
            s += sec
            n += cnt
    return s, n


def breakdown(red: Dict) -> Dict:
    ops = sorted(red["per_op"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
