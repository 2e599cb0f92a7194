"""Seconds from the process's start to the window's start: imports, the
kernel build where it is not built yet, weights and traffic made on the
card, the checked or warm-up items."""
UNIT = "s"


def read(rec):
    if rec.trace is not None:
        return None
    return rec.setup_s
