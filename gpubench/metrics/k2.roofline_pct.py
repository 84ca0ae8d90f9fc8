"""k2.roofline_pct: K2's least time for the window's samples
(``yardstick/bounds.k2_bytes`` at the HBM peak) over K2's device time in
the trace (kernels named ``lookup_kernel``), in percent."""

from gpubench.trace import device_seconds


def read(run):
    if run.trace is None or run.k2_bound_s is None:
        return None
    sec, n = device_seconds(run.trace, "lookup_kernel")
    if n == 0 or sec <= 0:
        return None
    return 100.0 * run.k2_bound_s * len(run.samples) / sec
