"""resolve.s_per_sample: the ``resolve`` timer (``resolve_signatures``,
the signatures' intersection into classes) a sample. The table's
read-back and ``merge_sig_rows`` run before it, in ``map``'s ``finalize``
(``finalize.s_per_sample``)."""


def read(run):
    if not run.samples:
        return None
    return sum(s.get("resolve_s", 0.0) for s in run.samples) / len(run.samples)
