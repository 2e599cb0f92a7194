"""Device ms per fragment of the kernels launched inside the
layer::occ_init ranges: the occupancy initialisation, its variance kernel included."""
UNIT = "ms"
RANGES = {"modules": {"occ_init": ["neucon_net.initialization"]}, "functions": {"occ_init": []}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("occ_init")
    return None if dev is None else 1e3 * dev / rec.trace.items
