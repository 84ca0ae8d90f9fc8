"""map_stage.wait_pct: 100 x the ``map_wait`` spans (the feed loop's waits
for the producer thread's next batch) over the ``map`` spans, summed over
the window's samples."""


def read(run):
    if not run.samples or any("map_wait_s" not in s for s in run.samples):
        return None
    t = sum(s.get("map_s", 0.0) for s in run.samples)
    w = sum(s["map_wait_s"] for s in run.samples)
    return 100.0 * w / t if t > 0 else None
