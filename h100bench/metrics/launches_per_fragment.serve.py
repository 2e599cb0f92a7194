"""Kernel launches per fragment in the traced window (host dispatch of
the stream entry and the model)."""
UNIT = "launches"


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    return rec.trace.kernels / rec.trace.items
