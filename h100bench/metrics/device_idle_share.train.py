"""Share of the traced window in which no operation ran on the device:
1 - (union of device activity intervals) / (the window's host seconds)."""
UNIT = "%"


def read(rec):
    if rec.program != "train" or rec.trace is None or not rec.trace.kernels:
        return None
    t = rec.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
