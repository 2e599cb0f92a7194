"""Frozen copy of the port's per-fragment inference program: model
forward, panoptic post-processing and direct-substitute global fusion."""
from __future__ import annotations

from typing import Optional

import torch

from h100bench.reference.epr.config import ModelConfig
from h100bench.reference.epr.models.eprecon import EPRecon, FragmentTargets
from h100bench.reference.epr.models.gru_fusion import fuse_tsdf_direct
from h100bench.reference.epr.models.panoptic.post import panoptic_inference
from h100bench.reference.epr.ops import sparse as sp


@torch.no_grad()
def fragment_forward(model: EPRecon, cfg, imgs, frag, rec_state,
                     pmap_state, targets: Optional[FragmentTargets] = None):
    """The complete per-fragment inference program: model forward +
    panoptic post-processing + direct-substitute global fusion. With
    `targets` the losses are computed against the GT too, as the reference
    test loop does (main.py:375-401)."""
    outputs, losses, new_rec = model(imgs, frag, rec_state, targets)
    seg = panoptic_inference(outputs["pred_logits"], outputs["pred_masks"],
                             outputs["panoptic_valid"])
    seg_window = sp.sparse_to_dense(
        outputs["coords"][:, 1:], seg.voxel_seg[:, None], outputs["valid"],
        cfg.model.n_vox)[..., 0]
    new_pmap = fuse_tsdf_direct(
        pmap_state, outputs["tsdf_window"], outputs["occupancy"], seg_window,
        seg.seg_class, seg.seg_isthing, seg.seg_valid, frag.rel_origins[-1])
    return outputs, losses, new_rec, new_pmap
