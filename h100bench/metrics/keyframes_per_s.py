"""Keyframes reconstructed per second: views x fragments completed in the
window, over the window's seconds (host clock; completion from each
fragment's CUDA event)."""
UNIT = "keyframes/s"


def read(rec):
    if rec.program != "serve" or rec.trace is not None:
        return None
    return rec.views * rec.completed / rec.window_s
