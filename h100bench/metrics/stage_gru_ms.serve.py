"""Device ms per fragment of the kernels launched inside the
layer::stage_gru ranges: each stage's GRU fusion against the global map."""
UNIT = "ms"
RANGES = {"modules": {"stage_gru": ["neucon_net.gru_fusion_0", "neucon_net.gru_fusion_1", "neucon_net.gru_fusion_2"]}, "functions": {"stage_gru": []}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("stage_gru")
    return None if dev is None else 1e3 * dev / rec.trace.items
