"""finalize.s_per_sample: the ``finalize`` span (the signature table's
read-back and ``merge_sig_rows``, at the end of ``map``) a sample."""


def read(run):
    return run.per_sample("finalize_s")
