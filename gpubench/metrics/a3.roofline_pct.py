"""a3.roofline_pct: A3's least time over every A3 launch of the window
(EM at B = 1 and the bootstrap at B replicates, each at the iterations the
sample reports; ``yardstick/bounds.a3_seconds``) over A3's device time in
the trace (kernels named ``em_csr_kernel``), in percent."""

from gpubench.trace import device_seconds


def read(run):
    if run.trace is None or not run.a3_bound_s:
        return None
    sec, n = device_seconds(run.trace, "em_csr_kernel")
    if n == 0 or sec <= 0:
        return None
    return 100.0 * run.a3_bound_s / sec
