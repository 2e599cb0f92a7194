"""Host wall ms per micro-step of the program's train::all_reduce range
(packing, the collective, unpacking); nothing on one rank."""
UNIT = "ms"


def read(rec):
    if rec.program != "train" or rec.trace is None or not rec.trace.kernels:
        return None
    host = rec.trace.range_host_s.get("train::all_reduce")
    return None if host is None else 1e3 * host / rec.trace.items
