"""Kernel launches per micro-step in the traced cycle (host dispatch of
the training entry: forward, backward, optimizer, collective)."""
UNIT = "launches"


def read(rec):
    if rec.program != "train" or rec.trace is None or not rec.trace.kernels:
        return None
    return rec.trace.kernels / rec.trace.items
