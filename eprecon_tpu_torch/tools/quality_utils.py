"""The closed quality loop's pieces: the tiny quality config, its synthetic
scene, the GT fused on the reconstructed grid, and the score of a
reconstruction against that GT (port of the JAX package's
tests/quality_utils.py:20-175 and of the window F-score of
tests/test_quality_loop.py:56-79).

The score is the mesh F-score of marching-cubes meshes (prediction against
GT re-fused on the whole reconstructed grid), the F-score against each
fragment's finest GT window, and panoptic quality under the reference's
label-transfer protocol: predicted labels move onto GT geometry by nearest
neighbour before PQ (reference tools/generate_semantic_instance.py:54-80).
`reconstruct` and `score_result` are apart so that the scoring can be held
against the JAX package's on the same arrays. Trained weights are the
model's own parameters and buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from eprecon_tpu_torch.config import Config, default_config
from eprecon_tpu_torch.data.synthetic import (make_fragment, make_scene,
                                              voxel_labels)
from eprecon_tpu_torch.device import DeviceLike
from eprecon_tpu_torch.inference.mesh_export import marching_cubes
from eprecon_tpu_torch.inference.pipeline import (SceneResult,
                                                  StreamingReconstructor)
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.ops import tsdf_fusion
from eprecon_tpu_torch.tools.evaluation_utils import (eval_mesh,
                                                      panoptic_quality,
                                                      transfer_labels_to_gt)

# the quality floors' mesh protocol (tests/quality_utils.py:149-150)
MESH_THRESHOLD = 0.15
MESH_DOWN_SAMPLE = 0.06


def tiny_cfg() -> Config:
    """The quality loop's tiny config (tests/quality_utils.py:20-41): a
    32^3 window at 12 cm, small decoder, abort floors scaled to the window
    (50 of 512 coarse voxels), occ_init_threshold 0.05 (the init head
    sits at its class prior, sigmoid ~0.08, before its variance features
    discriminate), lr 1e-3 without accumulation."""
    cfg = default_config()
    pan = dataclasses.replace(cfg.model.panoptic, num_queries=16, dec_layers=2,
                              max_instances=8, hidden_dim=16, nheads=4,
                              min_instance_voxels=10)
    m = dataclasses.replace(
        cfg.model, n_vox=(32, 32, 32), voxel_size=0.12,
        voxel_capacity=(512, 2048, 8192), global_extent=(64, 64, 32),
        min_init_voxels=50, min_stage_voxels=10, occ_init_threshold=0.05,
        panoptic=pan)
    t = dataclasses.replace(cfg.train, lr=1e-3, accumulation_steps=1)
    return dataclasses.replace(cfg, model=m, train=t)


def build_scene_and_fragments(cfg: Config, n_objects: int = 3,
                              n_views: int = 5,
                              image_hw: Tuple[int, int] = (96, 128),
                              seed: int = 3,
                              angles: Sequence[float] = (0.0, 0.6, 1.2),
                              scene_seed: int = 3):
    """(scene, fragments, samples): `scene_seed` picks the box layout,
    `seed` is make_fragment's own seed; the defaults are the scene every
    trained floor was calibrated on. A sample carries the keys of the data
    pipeline (train/loop.fragment_to_device_args takes it)."""
    scene = make_scene(seed=scene_seed, n_boxes=n_objects)
    frags = [make_fragment(n_views=n_views, image_hw=image_hw,
                           n_vox=cfg.model.n_vox,
                           voxel_size=cfg.model.voxel_size, seed=seed,
                           scene=scene, start_angle=a) for a in angles]
    samples = [dict(scene="s", imgs=d["imgs"],
                    proj_matrices=d["proj_matrices"],
                    vol_origin=d["vol_origin_partial"],
                    vol_origin_partial=d["vol_origin_partial"],
                    world_to_aligned_camera=d["world_to_aligned_camera"],
                    tsdf_list=d["tsdf_levels"], occ_list=d["occ_levels"],
                    semantic=d["semantic"], instance=d["instance"])
               for d in frags]
    return scene, frags, samples


def gt_on_grid(scene, frags: Sequence[dict], origin: np.ndarray,
               dim: Sequence[int], vsz: float):
    """GT tsdf, occupancy and labels fused from every view of `frags` on
    the reconstructed grid (origin, dim, voxel size)."""
    cat = lambda k: torch.from_numpy(np.concatenate([f[k] for f in frags]))
    t, w = tsdf_fusion.fuse_frames(
        cat("depths"), cat("intrinsics"), cat("poses"),
        torch.as_tensor(np.asarray(origin), dtype=torch.float32),
        tuple(int(x) for x in dim), vsz, margin=3)
    t, w = t.numpy(), w.numpy()
    occ = (np.abs(t) < 0.999) & (w > 1)
    sem, ins = voxel_labels(scene, np.asarray(origin), vsz, tuple(dim))
    return t, occ, np.where(occ, sem, 0), np.where(occ, ins, 0)


def reconstruct(cfg: Config, model: EPRecon, frags: Sequence[dict],
                device: DeviceLike = None) -> Optional[SceneResult]:
    """Stream `frags` through a StreamingReconstructor and flush the
    scene. The reconstructor puts `model` in eval mode; the caller puts it
    back in train mode to go on training."""
    recon = StreamingReconstructor(cfg, model, device)
    for d in frags:
        recon.process_fragment("s", d["imgs"], d["proj_matrices"],
                               d["vol_origin_partial"],
                               d["vol_origin_partial"],
                               d["world_to_aligned_camera"])
    return recon.flush()


def _cls_map(seg: np.ndarray, sem: np.ndarray) -> Dict[int, int]:
    out = {}
    for i in np.setdiff1d(np.unique(seg), [0]):
        vals = sem[seg == i]
        out[int(i)] = int(np.bincount(vals).argmax()) if len(vals) else 0
    return out


def _verts(tsdf: np.ndarray) -> np.ndarray:
    if not (np.abs(tsdf) < 1).any():
        return np.zeros((0, 3))
    return marching_cubes(tsdf)[0]


def window_gt_verts(frags: Sequence[dict], voxel_size: float) -> np.ndarray:
    """World vertices of each fragment's finest GT window's mesh."""
    out = [_verts(d["tsdf_levels"][0]) * voxel_size + d["vol_origin_partial"]
           for d in frags if (np.abs(d["tsdf_levels"][0]) < 1).any()]
    return np.concatenate(out) if out else np.zeros((0, 3))


def score_result(result: Optional[SceneResult], scene,
                 frags: Sequence[dict]) -> Dict[str, float]:
    """Score a reconstruction against the scene's GT: fscore / prec /
    recal (and dist1 / dist2) against GT re-fused on the reconstructed
    grid, window_fscore / window_prec / window_recal against the
    fragments' finest GT windows, PQ / SQ / RQ (with tp / fp / fn) under
    label transfer, and the instance counts. A reconstruction with no
    surface scores 0 with n_gt_inst -1, as the JAX package's does."""
    zero = dict(fscore=0.0, prec=0.0, recal=0.0, window_fscore=0.0,
                window_prec=0.0, window_recal=0.0, PQ=0.0, SQ=0.0, RQ=0.0,
                n_pred_inst=0, n_gt_inst=-1)
    if result is None or not (np.abs(result.tsdf) < 1).any():
        return zero
    vsz = float(result.voxel_size)
    origin = result.origin
    gt_tsdf, gt_occ, gt_sem, gt_ins = gt_on_grid(
        scene, frags, origin, result.tsdf.shape, vsz)
    pv = _verts(result.tsdf) * vsz + origin
    m: Dict[str, float] = dict(eval_mesh(
        pv, _verts(gt_tsdf) * vsz + origin,
        threshold=MESH_THRESHOLD, down_sample=MESH_DOWN_SAMPLE))
    mw = eval_mesh(pv, window_gt_verts(frags, vsz),
                   threshold=MESH_THRESHOLD, down_sample=MESH_DOWN_SAMPLE)
    m.update(window_fscore=mw["fscore"], window_prec=mw["prec"],
             window_recal=mw["recal"])

    sel3 = gt_occ & (gt_ins > 0)
    ps, pi = transfer_labels_to_gt(result.semantic, result.instance, origin,
                                   sel3, origin, vsz)
    gt_i, gt_s = gt_ins[sel3], gt_sem[sel3]
    m["n_gt_inst"] = int(len(np.setdiff1d(np.unique(gt_i), [0])))
    m["n_pred_inst"] = int(len(np.setdiff1d(np.unique(result.instance), [0])))
    if not (pi > 0).any():
        m.update(PQ=0.0, SQ=0.0, RQ=0.0)
        return m
    m.update(panoptic_quality(pi, _cls_map(pi, ps), gt_i, _cls_map(gt_i, gt_s)))
    return m


def score_vs_gt(cfg: Config, model: EPRecon, frags: Sequence[dict], scene,
                device: DeviceLike = None) -> Dict[str, float]:
    """Reconstruct with `model` and score against GT (score_result)."""
    return score_result(reconstruct(cfg, model, frags, device), scene, frags)
