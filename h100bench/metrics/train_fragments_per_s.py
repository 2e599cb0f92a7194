"""Training micro-steps (one fragment each) completed on all ranks per
second, over a window of whole accumulation cycles (host clock, the card
synchronised at the window's ends)."""
UNIT = "fragments/s"


def read(rec):
    if rec.program != "train" or rec.trace is not None:
        return None
    return rec.completed * rec.ranks / rec.window_s
