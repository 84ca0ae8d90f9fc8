"""resolve.s_per_sample: the ``resolve`` timer (the table's read-back,
``merge_sig_rows`` and ``resolve_signatures``) a sample."""


def read(run):
    if not run.samples:
        return None
    return sum(s.get("resolve_s", 0.0) for s in run.samples) / len(run.samples)
