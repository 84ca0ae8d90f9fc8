"""resample.s_per_sample: the ``resample`` span (the bootstrap's
multinomial resample of the class counts, inside ``bootstrap``) a
sample."""


def read(run):
    return run.per_sample("resample_s")
