"""The back-projection kernels' share of their roofline: the least time
of the calls the traced items need (h100bench/harness/bp_cost.py) over
the device time of the kernels launched inside the eprecon_tpu_torch::*
custom-op ranges. Nothing to read where no such range ran."""
UNIT = "%"


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels or not rec.bp_bound_s_per_item:
        return None
    t = rec.trace
    dev = sum(t.op_device_s.values())
    if dev <= 0:
        return None
    return 100.0 * rec.bp_bound_s_per_item * t.items / dev
