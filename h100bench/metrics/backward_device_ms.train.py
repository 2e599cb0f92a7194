"""Kernel device ms per micro-step outside the program's train::forward,
train::optimizer and train::all_reduce ranges: the backward (which runs
on autograd's thread) and the uploads."""
UNIT = "ms"


def read(rec):
    if rec.program != "train" or rec.trace is None or not rec.trace.kernels:
        return None
    t = rec.trace
    inside = sum(t.range_device_s.get(k, 0.0) for k in
                 ("train::forward", "train::optimizer", "train::all_reduce"))
    return 1e3 * (t.device_s - inside) / t.items
