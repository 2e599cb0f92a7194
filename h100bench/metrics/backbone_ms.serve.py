"""Device ms per fragment of the kernels launched inside the
layer::backbone ranges: the two MnasMulti backbones."""
UNIT = "ms"
RANGES = {"modules": {"backbone": ["backbone2d", "backbone_occ_pano"]}, "functions": {"backbone": []}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("backbone")
    return None if dev is None else 1e3 * dev / rec.trace.items
