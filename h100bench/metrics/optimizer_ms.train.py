"""Host wall ms per micro-step of the program's optimizer step (the call
its train::optimizer range wraps), timed by the host clock over one
untraced accumulation cycle after the traced one, so that the profiler's
cost per launch is left out."""
UNIT = "ms"


def read(rec):
    if rec.program != "train" or not rec.optimizer_steps:
        return None
    return 1e3 * rec.optimizer_host_s / rec.optimizer_steps
