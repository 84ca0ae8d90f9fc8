"""em.iters_per_s: EM iterations over the ``em`` timer, summed over the
window's samples."""


def read(run):
    t = sum(s.get("em_s", 0.0) for s in run.samples)
    n = sum(s.get("em_iterations", 0.0) for s in run.samples)
    return n / t if t > 0 and n > 0 else None
