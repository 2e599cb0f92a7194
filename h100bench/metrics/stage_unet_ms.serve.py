"""Device ms per fragment of the kernels launched inside the
layer::stage_unet ranges: each stage's dense U-Net and its tsdf / occupancy heads."""
UNIT = "ms"
RANGES = {"modules": {"stage_unet": ["neucon_net.sp_conv_0", "neucon_net.sp_conv_1", "neucon_net.sp_conv_2", "neucon_net.tsdf_pred_0", "neucon_net.tsdf_pred_1", "neucon_net.tsdf_pred_2", "neucon_net.occ_pred_0", "neucon_net.occ_pred_1", "neucon_net.occ_pred_2"]}, "functions": {"stage_unet": []}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("stage_unet")
    return None if dev is None else 1e3 * dev / rec.trace.items
