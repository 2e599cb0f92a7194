"""The whole step's share of the card's peak: model FLOPs per item
(h100bench/harness/flops.py, from the configuration's shapes) times the
items traced, over the traced window's seconds, against 989 TFLOP/s
(bf16 dense)."""
from h100bench.harness.peaks import BF16_FLOPS_PER_S

UNIT = "%"


def read(rec):
    if rec.program != "train" or rec.trace is None or not rec.trace.kernels or not rec.flops_per_item:
        return None
    t = rec.trace
    return 100.0 * rec.flops_per_item * t.items / t.window_s / BF16_FLOPS_PER_S
