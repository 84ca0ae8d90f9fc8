"""bootstrap.s_per_sample: the ``bootstrap`` timer (resample, A3 at B
replicates) a sample."""


def read(run):
    if not run.samples:
        return None
    return (sum(s.get("bootstrap_s", 0.0) for s in run.samples)
            / len(run.samples))
