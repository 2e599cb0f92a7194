"""Device ms per fragment of the kernels launched inside the
layer::panoptic ranges: the panoptic heads, mask features, compaction and decoder."""
UNIT = "ms"
RANGES = {"modules": {"panoptic": ["neucon_net.panoptic_pred_0", "neucon_net.panoptic_pred_1", "neucon_net.panoptic_pred_2", "neucon_net.mask_feat_0", "neucon_net.mask_feat_1", "neucon_net.mask_feat_2", "neucon_net.panoptic"]}, "functions": {"panoptic": ["eprecon_tpu_torch.ops.sparse:dense_to_sparse", "eprecon_tpu_torch.ops.sparse:compact", "eprecon_tpu_torch.models.eprecon:nearest_fine_in_cell"]}}


def read(rec):
    if rec.program != "serve" or rec.trace is None or not rec.trace.kernels:
        return None
    dev = rec.trace.range_device_s.get("panoptic")
    return None if dev is None else 1e3 * dev / rec.trace.items
