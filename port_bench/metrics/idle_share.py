"""The share of the traced window in which no operation ran on the device:
the window less the union of the kernels', copies' and fills' intervals."""


def read(run):
    t = run.traced
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
