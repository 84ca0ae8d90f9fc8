"""mapper.s_per_sample: the ``mapper`` span (the ``Mapper``'s build: the
index's upload to the card and its on-card layout) a sample."""


def read(run):
    return run.per_sample("mapper_s")
