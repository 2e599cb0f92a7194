"""GRU temporal fusion with dense global volumes (port of
eprecon_tpu/models/gru_fusion.py:32-292; reference models/gru_fusion.py).

The per-scene global state is a dense volume per pyramid level; a
fragment's window is sliced out, fused by two ConvGRUs (voxel / image
branches) over the union of current and global voxels, and written back.
Maps are [Gx, Gy, Gz, C] (the JAX package's [Gx, Gy, Gz*C] lane-flattening
is a TPU layout and is not kept). Window origins are int tensors on the
device, as the JAX version traces them, so one exported program serves
every fragment position; the writeback is in place, which stands for the
JAX version's donated buffers. GT TSDF windows fuse into a parallel
dense target volume per level (`DenseTargetLevel`) for the training loss.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from h100bench.reference.epr.fragment_io import (DenseGlobalLevel,  # noqa: F401
                                          DenseTargetLevel,
                                          PanopticGlobalDense)
from h100bench.reference.epr.models.layers import remat
from h100bench.reference.epr.models.unet_dense import DenseConvGRU

MAX_GLOBAL_INSTANCES = 1024  # id table bound for IoU matching


def window_index(vol: torch.Tensor, rel_origin,
                 window: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Broadcast index tensors of the [X, Y, Z] window of `vol` at
    rel_origin [3], clamped into the volume (dynamic_slice semantics).
    The origin is data on the volume's device, not Python ints, so one
    exported program serves every fragment position; `vol[idx]` copies
    the window out and `vol[idx] = win` writes it back in place."""
    o = torch.as_tensor(rel_origin, device=vol.device)
    idx = []
    for i in range(3):
        start = o[i].clamp(0, vol.shape[i] - window[i])
        shape = [1, 1, 1]
        shape[i] = window[i]
        idx.append((start + torch.arange(window[i], device=vol.device))
                   .reshape(shape))
    return tuple(idx)


class DenseGRUFusion(nn.Module):
    """Feature-mode fusion at one level on dense windows
    (reference gru_fusion.py:259-394, FUSION.FULL, batch=1). With `remat`
    (the JAX module's default) the training backward recomputes the two
    ConvGRUs, and only them: the global map's slice and writeback stay
    outside the recompute, as in the JAX module."""

    def __init__(self, ch_voxel: int, ch_img: int, remat: bool = True):
        super().__init__()
        self.ch_voxel = ch_voxel
        self.remat = remat
        self.gru_voxel = DenseConvGRU(ch_voxel, ch_voxel)
        self.gru_img = DenseConvGRU(ch_img, ch_img)

    def forward(self, cur_feats: torch.Tensor, cur_mask: torch.Tensor,
                gmap: DenseGlobalLevel, rel_origin: torch.Tensor):
        """cur_feats [X, Y, Z, C] (voxel ++ img channels). Returns (fused
        [X, Y, Z, C], union mask, gmap) with gmap updated in place."""
        idx = window_index(gmap.mask, rel_origin, cur_mask.shape)
        g_feats = gmap.feats[idx].to(cur_feats.dtype)
        g_mask = gmap.mask[idx]
        union = g_mask | cur_mask
        h = torch.where(g_mask[..., None], g_feats, 0)
        x = torch.where(cur_mask[..., None], cur_feats, 0)
        cv = self.ch_voxel
        fv = remat(self.gru_voxel, h[..., :cv], x[..., :cv], union,
                   enabled=self.remat)
        fi = remat(self.gru_img, h[..., cv:], x[..., cv:], union,
                   enabled=self.remat)
        fused = torch.where(union[..., None], torch.cat([fv, fi], dim=-1), 0)
        # truncated BPTT, as the reference detaches its global volumes
        # between fragments: the map takes no gradient and holds no graph
        gmap.feats[idx] = fused.detach().to(gmap.feats.dtype)
        gmap.mask[idx] = union
        return fused, union, gmap


def fuse_target_window(tmap: DenseTargetLevel, tsdf_window: torch.Tensor,
                       occ_window: torch.Tensor, rel_origin: torch.Tensor):
    """Fuse a fragment's GT window into the global target volume, in
    place, and return the fused window (reference gru_fusion.py:101-110:
    the current fragment overwrites where it is occupied).
    Returns (tsdf [X, Y, Z], occ [X, Y, Z], tmap)."""
    idx = window_index(tmap.tsdf, rel_origin, tsdf_window.shape)
    g_tsdf, g_occ = tmap.tsdf[idx], tmap.occ[idx]
    fused = torch.where(occ_window, tsdf_window,
                        torch.where(g_occ, g_tsdf, 1.0))
    fused_occ = occ_window | g_occ
    tmap.tsdf[idx] = fused
    tmap.occ[idx] = fused_occ
    return fused, fused_occ, tmap


# ---------------------------------------------------------------------------
# Direct-substitute mode (inference): dense global TSDF + panoptic ids
# (reference gru_fusion.py:17-20,94,352-370 + panoptic_fusion :133-193)
# ---------------------------------------------------------------------------

def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int):
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids.long(), values)


def panoptic_instance_match(g_instance, g_semantic, g_count, g_class, next_id,
                            seg_ids, seg_class, seg_isthing, seg_valid,
                            vox_valid, overlap_threshold: float = 0.05):
    """Cross-fragment instance id assignment (reference gru_fusion.py:133-193).

    A predicted thing segment inherits the id of the same-class global
    instance with the largest IoU above the threshold, else gets a fresh
    id; stuff keeps its class id. Inputs as in the JAX function (flattened
    window ids, [MAX_GLOBAL_INSTANCES] global tables, [S+1] segment
    tables). Returns (vox_instance [N], vox_semantic [N], next_id).
    """
    s_max = seg_class.shape[0]
    gid = torch.where(vox_valid, g_instance.clamp(0, MAX_GLOBAL_INSTANCES - 1), 0)
    live = vox_valid & (seg_ids > 0)
    pair = torch.where(live, seg_ids * MAX_GLOBAL_INSTANCES + gid, 0)
    inter = _segment_sum((live & (gid > 0)).int(), pair,
                         s_max * MAX_GLOBAL_INSTANCES
                         ).reshape(s_max, MAX_GLOBAL_INSTANCES)
    seg_size = _segment_sum(live.int(), torch.where(vox_valid, seg_ids, 0),
                            s_max)
    union = seg_size[:, None] + g_count[None, :] - inter
    iou = inter / union.clamp(min=1)
    same_class = seg_class[:, None] == g_class[None, :]
    iou = torch.where(same_class & (g_count[None, :] > 0), iou, 0.0)
    iou[:, 0] = 0.0

    best_iou = iou.amax(dim=1)
    best_gid = iou.argmax(dim=1)  # first maximum, as jnp.argmax
    matched = best_iou > overlap_threshold
    need_new = seg_valid & seg_isthing & ~matched
    new_offsets = torch.cumsum(need_new.int(), 0, dtype=torch.int32)
    fresh_id = next_id + new_offsets
    seg_new_instance = torch.where(
        seg_isthing, torch.where(matched, best_gid.int(), fresh_id), seg_class)
    vox_seg = torch.where(vox_valid, seg_ids, 0).long()
    vox_instance = torch.where(vox_seg > 0, seg_new_instance[vox_seg], 0)
    vox_semantic = torch.where(vox_seg > 0, seg_class[vox_seg], 0)
    return vox_instance, vox_semantic, next_id + new_offsets[-1]


def fuse_tsdf_direct(gmap: PanopticGlobalDense, tsdf_window, cur_mask,
                     seg_window, seg_class, seg_isthing, seg_valid,
                     rel_origin: torch.Tensor) -> PanopticGlobalDense:
    """Direct-substitute fusion of a fragment's final TSDF + panoptic
    segment window into the global map, in place (reference gru_fusion.py
    direct mode). tsdf_window / cur_mask / seg_window: [X, Y, Z]."""
    window = tuple(tsdf_window.shape)
    idx = window_index(gmap.tsdf, rel_origin, window)
    g_tsdf, g_mask = gmap.tsdf[idx], gmap.mask[idx]
    g_inst, g_sem = gmap.instance[idx], gmap.semantic[idx]

    fused_tsdf = torch.where(cur_mask, tsdf_window,
                             torch.where(g_mask, g_tsdf, 1.0))
    union = (fused_tsdf.abs() < 1.0) & (cur_mask | g_mask)

    # global per-instance stats over the whole map
    gid_all = torch.where(gmap.mask, gmap.instance.clamp(
        0, MAX_GLOBAL_INSTANCES - 1), 0).reshape(-1).long()
    g_count = _segment_sum(gmap.mask.reshape(-1).int(), gid_all,
                           MAX_GLOBAL_INSTANCES)
    g_count[0] = 0
    g_class = torch.full((MAX_GLOBAL_INSTANCES,), torch.iinfo(torch.int32).min,
                         dtype=torch.int32, device=gid_all.device)
    g_class = g_class.scatter_reduce(
        0, gid_all, torch.where(gmap.mask, gmap.semantic, 0).reshape(-1),
        reduce="amax")

    vox_inst, vox_sem, next_id = panoptic_instance_match(
        g_inst.reshape(-1), g_sem.reshape(-1), g_count, g_class,
        gmap.next_instance_id,
        torch.where(cur_mask, seg_window, 0).reshape(-1),
        seg_class, seg_isthing, seg_valid, union.reshape(-1))
    pred = cur_mask & (seg_window > 0)
    new_inst = torch.where(pred, vox_inst.reshape(window),
                           torch.where(g_mask, g_inst, 0))
    new_sem = torch.where(pred, vox_sem.reshape(window),
                          torch.where(g_mask, g_sem, 0))

    gmap.tsdf[idx] = fused_tsdf
    gmap.instance[idx] = new_inst.int()
    gmap.semantic[idx] = new_sem.int()
    gmap.mask[idx] = union
    gmap.next_instance_id = next_id
    return gmap
