"""device.idle_pct: 100 x (1 - the union of kernel and copy intervals
over the traced window)."""


def read(run):
    red = run.trace
    if red is None or red["busy_s"] <= 0 or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
