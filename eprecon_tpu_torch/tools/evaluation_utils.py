"""3D mesh and panoptic evaluation metrics, numpy and scipy (own copy of
eprecon_tpu/tools/evaluation_utils.py; the depth metrics come with the
depth protocol).

Reference: tools/evaluation_utils.py:5-42 — eval_mesh computes bidirectional
nearest-neighbor point distances (2 cm downsample, 5 cm inlier threshold →
dist1/dist2/precision/recall/F-score). KD-trees come from scipy (the
reference used open3d's; identical math).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def uniform_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Keep one point per `voxel`-sized cell (open3d voxel_down_sample
    equivalent)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def nn_correspondance(verts1: np.ndarray, verts2: np.ndarray) -> np.ndarray:
    """For each vert in verts2, distance to the nearest vert in verts1
    (reference evaluation_utils.py:45-70)."""
    from scipy.spatial import cKDTree

    if len(verts1) == 0 or len(verts2) == 0:
        return np.zeros(0)
    tree = cKDTree(verts1)
    dist, _ = tree.query(verts2, k=1, workers=-1)  # all cores; same result
    return dist


def eval_mesh(verts_pred: np.ndarray, verts_gt: np.ndarray,
              threshold: float = 0.05, down_sample: float = 0.02) -> Dict[str, float]:
    """reference evaluation_utils.py:5-42."""
    if down_sample:
        verts_pred = uniform_downsample(verts_pred, down_sample)
        verts_gt = uniform_downsample(verts_gt, down_sample)
    dist1 = nn_correspondance(verts_pred, verts_gt)   # gt → pred
    dist2 = nn_correspondance(verts_gt, verts_pred)   # pred → gt
    precision = float(np.mean((dist2 < threshold).astype(np.float64))) if len(dist2) else 0.0
    recal = float(np.mean((dist1 < threshold).astype(np.float64))) if len(dist1) else 0.0
    fscore = 2 * precision * recal / (precision + recal) if precision + recal > 0 else 0.0
    return dict(
        dist1=float(np.mean(dist2)) if len(dist2) else np.inf,  # pred→gt (acc)
        dist2=float(np.mean(dist1)) if len(dist1) else np.inf,  # gt→pred (compl)
        prec=precision, recal=recal, fscore=fscore,
    )


def panoptic_quality(pred_seg: np.ndarray, pred_cls: Dict[int, int],
                     gt_seg: np.ndarray, gt_cls: Dict[int, int],
                     iou_threshold: float = 0.5) -> Dict[str, float]:
    """Voxel-level PQ/SQ/RQ (the metric the reference defers to the external
    ScanNet benchmark; provided natively here for closed-loop evaluation).

    pred_seg/gt_seg: [N] per-voxel segment ids (0 = void); *_cls: id → class.

    Vectorized: one bincount builds the full [G, P] contingency table, so
    cost is O(N + G*P) instead of O(N * G * P) python loops — benchmark-scale
    eval over many scenes stays cheap. At iou_threshold >= 0.5 each segment
    can match at most one counterpart, so thresholding IS the matching.
    """
    pred_seg = np.asarray(pred_seg).reshape(-1)
    gt_seg = np.asarray(gt_seg).reshape(-1)
    pred_ids, pred_inv = np.unique(pred_seg, return_inverse=True)
    gt_ids, gt_inv = np.unique(gt_seg, return_inverse=True)
    g, p = len(gt_ids), len(pred_ids)
    cont = np.bincount(gt_inv.astype(np.int64) * p + pred_inv,
                       minlength=g * p).reshape(g, p).astype(np.float64)
    gt_area = cont.sum(axis=1, keepdims=True)
    pred_area = cont.sum(axis=0, keepdims=True)
    union = gt_area + pred_area - cont
    iou = np.where(union > 0, cont / np.maximum(union, 1.0), 0.0)

    valid_g = gt_ids != 0
    valid_p = pred_ids != 0
    cls_g = np.array([gt_cls.get(int(i), -1) for i in gt_ids])
    cls_p = np.array([pred_cls.get(int(i), -2) for i in pred_ids])
    ok = (cls_g[:, None] == cls_p[None, :]) & valid_g[:, None] & valid_p[None, :]
    iou = np.where(ok, iou, 0.0)

    assert iou_threshold >= 0.5, "unique matching requires threshold >= 0.5"
    matched = iou > iou_threshold
    matches = iou[matched]
    tp = int(matched.sum())
    fp = int(valid_p.sum()) - tp
    fn = int(valid_g.sum()) - tp
    sq = float(np.mean(matches)) if tp else 0.0
    rq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) else 0.0
    return dict(PQ=sq * rq, SQ=sq, RQ=rq, tp=tp, fp=fp, fn=fn)


def transfer_labels_to_gt(pred_sem: np.ndarray, pred_ins: np.ndarray,
                          pred_origin: np.ndarray, gt_mask: np.ndarray,
                          gt_origin: np.ndarray, voxel_size: float,
                          max_dist: float = 3.0):
    """Nearest-neighbour transfer of predicted voxel labels onto GT voxels.

    This is the reference's panoptic evaluation protocol: predicted mesh
    labels are exported per vertex (reference
    tools/generate_semantic_instance.py:54-80) and the ScanNet benchmark
    transfers them to the GT geometry by nearest neighbour before scoring.
    Scoring a direct voxel-grid intersection instead is NOT the protocol —
    two thin surface shells offset by one voxel already score near-zero IoU.

    pred_sem/pred_ins: [Xp,Yp,Zp] predicted label volumes (0 = unlabeled);
    gt_mask: [Xg,Yg,Zg] bool — GT voxels to receive labels; origins in
    meters; max_dist in GT-voxel units. Returns (sem [N], ins [N]) aligned
    with np.argwhere(gt_mask) order; voxels with no predicted label within
    max_dist get 0 (void).
    """
    from scipy.spatial import cKDTree

    gt_pts = np.argwhere(gt_mask)
    labeled = np.argwhere(pred_sem > 0)
    if len(labeled) == 0 or len(gt_pts) == 0:
        z = np.zeros(len(gt_pts), np.int32)
        return z, z.copy()
    # bring predicted voxel centers into the GT index frame
    off = (np.asarray(pred_origin, np.float64)
           - np.asarray(gt_origin, np.float64)) / voxel_size
    d, idx = cKDTree(labeled + off[None, :]).query(gt_pts, k=1, workers=-1)
    near = d <= max_dist
    src = tuple(labeled[idx].T)
    sem = np.where(near, pred_sem[src], 0).astype(np.int32)
    ins = np.where(near, pred_ins[src], 0).astype(np.int32)
    return sem, ins
