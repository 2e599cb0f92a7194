"""95th percentile, over every fragment of the window, of the time from
its submission to its completion event (host clock at submission, the
completion event's device time mapped onto it)."""
import numpy as np

UNIT = "ms"


def read(rec):
    if rec.program != "serve" or rec.trace is not None or not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s) * 1e3, 95))
