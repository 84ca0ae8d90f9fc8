"""vs_baseline: the map stage's fragments/s over 10x the frozen single-core
CPU baseline's dense arm on the same host in the same run
(``BASELINE.json:5``'s target: >= 1)."""


def read(run):
    t = sum(s.get("map_s", 0.0) for s in run.samples)
    base = run.baseline_fragments_per_s
    if t <= 0 or not base:
        return None
    return run.fragments * len(run.samples) / t / (10.0 * base)
