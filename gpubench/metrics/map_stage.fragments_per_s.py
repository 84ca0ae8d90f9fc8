"""map_stage.fragments_per_s: the window's fragments over the summed
``map`` timers of its samples (``QuantResult.timings['map_s']``: ingest,
upload, map kernels and FLD sampling, ending in the table's read-back)."""


def read(run):
    t = sum(s.get("map_s", 0.0) for s in run.samples)
    return run.fragments * len(run.samples) / t if t > 0 else None
