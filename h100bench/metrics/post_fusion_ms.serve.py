"""Device ms per fragment of the kernels launched inside the
layer::post_fusion ranges: panoptic post-processing and the global TSDF / panoptic fusion."""
UNIT = "ms"
RANGES = {"modules": {"post_fusion": []}, "functions": {"post_fusion": ["eprecon_tpu_torch.inference.pipeline:panoptic_inference", "eprecon_tpu_torch.inference.pipeline:fuse_tsdf_direct"]}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("post_fusion")
    return None if dev is None else 1e3 * dev / rec.trace.items
