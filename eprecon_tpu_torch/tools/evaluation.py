"""Scene-level 3D evaluation against the generated GT volumes (port of
eprecon_tpu/tools/evaluation.py:157-224,270-290).

Reference: tools/evaluation.py:45-158 scores a predicted mesh against the
GT mesh (eval_mesh) after a depth-rendering protocol; the closed-loop
score here compares the finished scene's mesh with the GT volume's mesh
(F-score) and the predicted labels, transferred onto the GT voxels, with
the GT labels (PQ). The depth protocol (render the predicted TSDF at
held-out frames, depth metrics, trimmed re-fusion) is not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def evaluate_scene_vs_gt(result, gt_dir: str,
                         stuff_ids=(1, 2)) -> Dict[str, float]:
    """Closed-loop scene metrics against generated GT volumes: mesh F-score
    (eval_mesh protocol, reference tools/evaluation_utils.py:5-42) + native
    voxel PQ/SQ/RQ.

    result: inference.pipeline.SceneResult; gt_dir: the all_tsdf_9 directory
    holding <scene>/full_tsdf_layer0.npz (+ label volumes). GT and prediction
    share the scene world frame (fragment metas carry the GT vol_origin), so
    volumes are aligned by integer offset.
    """
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes
    from eprecon_tpu_torch.tools.evaluation_utils import eval_mesh, panoptic_quality

    root = os.path.join(gt_dir, result.name)
    gt_tsdf = np.load(os.path.join(root, "full_tsdf_layer0.npz"),
                      allow_pickle=True)["arr_0"]
    info = os.path.join(root, "tsdf_info.npz")
    if os.path.exists(info):
        gt_origin = np.load(info)["vol_origin"].astype(np.float32)
    else:
        gt_origin = None

    metrics: Dict[str, float] = {}
    vsz = float(result.voxel_size)
    if (np.abs(result.tsdf) < 1).any() and (np.abs(gt_tsdf) < 1).any():
        vp, _, _ = marching_cubes(result.tsdf)
        verts_pred = vp * vsz + result.origin[None, :]
        vg, _, _ = marching_cubes(gt_tsdf)
        if gt_origin is None:
            # without a recorded origin both meshes can only be compared in
            # the pred frame; assume GT shares the scene origin of the pred
            gt_origin = result.origin
        verts_gt = vg * vsz + gt_origin[None, :]
        metrics.update(eval_mesh(verts_pred, verts_gt))

    sem_p = os.path.join(root, "full_semantic_layer_interpolate0.npz")
    ins_p = os.path.join(root, "full_instance_layer_interpolate0.npz")
    if os.path.exists(sem_p) and os.path.exists(ins_p) and gt_origin is not None:
        from eprecon_tpu_torch.tools.evaluation_utils import transfer_labels_to_gt

        gt_sem = np.load(sem_p, allow_pickle=True)["arr_0"]
        gt_ins = np.load(ins_p, allow_pickle=True)["arr_0"]
        gt_occ = np.abs(gt_tsdf) < 0.999
        # reference protocol: predicted labels are transferred onto the GT
        # geometry by nearest neighbour before PQ (the ScanNet benchmark's
        # treatment of the per-vertex export from
        # reference tools/generate_semantic_instance.py:54-80)
        sel3 = gt_occ & (gt_ins > 0)
        pred_sem, pred_ins = transfer_labels_to_gt(
            result.semantic, result.instance, result.origin, sel3,
            gt_origin, vsz)
        gt_sem_v = gt_sem[sel3]
        gt_ins_v = gt_ins[sel3]

        # per-segment class maps by majority vote
        def cls_map(seg, sem):
            out = {}
            for i in np.unique(seg):
                if i == 0:
                    continue
                vals = sem[seg == i]
                out[int(i)] = int(np.bincount(vals).argmax()) if len(vals) else 0
            return out
        metrics.update(panoptic_quality(
            pred_ins, cls_map(pred_ins, pred_sem),
            gt_ins_v, cls_map(gt_ins_v, gt_sem_v)))
    return metrics


def gt_scene_verts(gt_dir: str, scene: str) -> Optional[np.ndarray]:
    """World-frame GT surface vertices from the generated GT volumes
    (marching cubes over full_tsdf_layer0; the reference compares against
    <scene>_vh_clean_2.ply mesh vertices — same protocol, different source
    because GT here is the fused volume)."""
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes

    root = os.path.join(gt_dir, scene)
    tsdf_p = os.path.join(root, "full_tsdf_layer0.npz")
    if not os.path.exists(tsdf_p):
        return None
    gt_tsdf = np.load(tsdf_p, allow_pickle=True)["arr_0"]
    if not (np.abs(gt_tsdf) < 1).any():
        return None
    info = os.path.join(root, "tsdf_info.npz")
    origin = (np.load(info)["vol_origin"].astype(np.float32)
              if os.path.exists(info) else np.zeros(3, np.float32))
    info_d = np.load(info) if os.path.exists(info) else {}
    vsz = float(info_d["voxel_size"]) if "voxel_size" in info_d else 0.04
    verts, _, _ = marching_cubes(gt_tsdf)
    return verts * vsz + origin[None, :]
