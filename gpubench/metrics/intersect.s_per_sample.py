"""intersect.s_per_sample: the ``intersect`` span (``resolve_signatures``'
loop over the multi-EC signatures, one ``np.intersect1d`` a class past the
first, inside ``resolve``) a sample; None where a sample lacks it."""


def read(run):
    return run.per_sample("intersect_s")
