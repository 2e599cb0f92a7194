"""GRU temporal fusion with dense global volumes (port of
eprecon_tpu/models/gru_fusion.py:32-292; reference models/gru_fusion.py).

The per-scene global state is a dense volume per pyramid level; a
fragment's window is sliced out, fused by two ConvGRUs (voxel / image
branches) over the union of current and global voxels, and written back.
Maps are [Gx, Gy, Gz, C] (the JAX package's [Gx, Gy, Gz*C] lane-flattening
is a TPU layout and is not kept). Window origins are host integers, so
slicing needs no device sync; the writeback is in place, which stands for
the JAX version's donated buffers. GT TSDF windows fuse into a parallel
dense target volume per level (`DenseTargetLevel`) for the training loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from eprecon_tpu_torch.models.unet_dense import DenseConvGRU

MAX_GLOBAL_INSTANCES = 1024  # id table bound for IoU matching


@dataclass
class DenseGlobalLevel:
    """Dense global feature volume at one pyramid level."""
    feats: torch.Tensor  # [Gx, Gy, Gz, C]
    mask: torch.Tensor   # [Gx, Gy, Gz] bool

    @staticmethod
    def empty(extent: Tuple[int, int, int], channels: int,
              dtype=torch.float32, device=None) -> "DenseGlobalLevel":
        return DenseGlobalLevel(
            torch.zeros(*extent, channels, dtype=dtype, device=device),
            torch.zeros(*extent, dtype=torch.bool, device=device))


@dataclass
class DenseTargetLevel:
    """Dense global GT-TSDF volume at one pyramid level (reference
    target_tsdf_volume)."""
    tsdf: torch.Tensor  # [Gx, Gy, Gz] f32 (init 1)
    occ: torch.Tensor   # [Gx, Gy, Gz] bool

    @staticmethod
    def empty(extent: Tuple[int, int, int], device=None) -> "DenseTargetLevel":
        return DenseTargetLevel(torch.ones(extent, device=device),
                                torch.zeros(extent, dtype=torch.bool,
                                            device=device))


def _clamp_origin(rel_origin: Sequence[int], extent, window) -> Tuple[int, ...]:
    """Window start clamped into the volume (dynamic_slice semantics)."""
    return tuple(int(np.clip(int(rel_origin[i]), 0, extent[i] - window[i]))
                 for i in range(3))


def _window_slices(vol: torch.Tensor, rel_origin, window):
    o = _clamp_origin(rel_origin, vol.shape[:3], window)
    return tuple(slice(o[i], o[i] + window[i]) for i in range(3))


def slice_window(vol: torch.Tensor, rel_origin: Sequence[int],
                 window: Tuple[int, int, int]) -> torch.Tensor:
    """View of the [X, Y, Z, ...] window at rel_origin (clamped)."""
    return vol[_window_slices(vol, rel_origin, window)]


def update_window(vol: torch.Tensor, win: torch.Tensor,
                  rel_origin: Sequence[int]) -> torch.Tensor:
    """Write `win` into `vol` at rel_origin (clamped), in place."""
    vol[_window_slices(vol, rel_origin, win.shape[:3])] = win
    return vol


class DenseGRUFusion(nn.Module):
    """Feature-mode fusion at one level on dense windows
    (reference gru_fusion.py:259-394, FUSION.FULL, batch=1)."""

    def __init__(self, ch_voxel: int, ch_img: int):
        super().__init__()
        self.ch_voxel = ch_voxel
        self.gru_voxel = DenseConvGRU(ch_voxel, ch_voxel)
        self.gru_img = DenseConvGRU(ch_img, ch_img)

    def forward(self, cur_feats: torch.Tensor, cur_mask: torch.Tensor,
                gmap: DenseGlobalLevel, rel_origin: Sequence[int]):
        """cur_feats [X, Y, Z, C] (voxel ++ img channels). Returns (fused
        [X, Y, Z, C], union mask, gmap) with gmap updated in place."""
        window = tuple(cur_mask.shape)
        g_feats = slice_window(gmap.feats, rel_origin, window).to(cur_feats.dtype)
        g_mask = slice_window(gmap.mask, rel_origin, window)
        union = g_mask | cur_mask
        h = torch.where(g_mask[..., None], g_feats, 0)
        x = torch.where(cur_mask[..., None], cur_feats, 0)
        cv = self.ch_voxel
        fv = self.gru_voxel(h[..., :cv], x[..., :cv], union)
        fi = self.gru_img(h[..., cv:], x[..., cv:], union)
        fused = torch.where(union[..., None], torch.cat([fv, fi], dim=-1), 0)
        # truncated BPTT, as the reference detaches its global volumes
        # between fragments: the map takes no gradient and holds no graph
        update_window(gmap.feats, fused.detach().to(gmap.feats.dtype),
                      rel_origin)
        update_window(gmap.mask, union, rel_origin)
        return fused, union, gmap


def fuse_target_window(tmap: DenseTargetLevel, tsdf_window: torch.Tensor,
                       occ_window: torch.Tensor, rel_origin: Sequence[int]):
    """Fuse a fragment's GT window into the global target volume, in
    place, and return the fused window (reference gru_fusion.py:101-110:
    the current fragment overwrites where it is occupied).
    Returns (tsdf [X, Y, Z], occ [X, Y, Z], tmap)."""
    window = tuple(tsdf_window.shape)
    g_tsdf = slice_window(tmap.tsdf, rel_origin, window)
    g_occ = slice_window(tmap.occ, rel_origin, window)
    fused = torch.where(occ_window, tsdf_window,
                        torch.where(g_occ, g_tsdf, 1.0))
    fused_occ = occ_window | g_occ
    update_window(tmap.tsdf, fused, rel_origin)
    update_window(tmap.occ, fused_occ, rel_origin)
    return fused, fused_occ, tmap


# ---------------------------------------------------------------------------
# Direct-substitute mode (inference): dense global TSDF + panoptic ids
# (reference gru_fusion.py:17-20,94,352-370 + panoptic_fusion :133-193)
# ---------------------------------------------------------------------------

@dataclass
class PanopticGlobalDense:
    tsdf: torch.Tensor      # [Gx, Gy, Gz] f32 (init 1)
    instance: torch.Tensor  # [Gx, Gy, Gz] int32
    semantic: torch.Tensor  # [Gx, Gy, Gz] int32
    mask: torch.Tensor      # [Gx, Gy, Gz] bool (observed near-surface)
    next_instance_id: torch.Tensor  # int32 scalar

    @staticmethod
    def empty(extent: Tuple[int, int, int], max_stuff: int = 2,
              device=None) -> "PanopticGlobalDense":
        i32 = torch.int32
        return PanopticGlobalDense(
            torch.ones(extent, device=device),
            torch.zeros(extent, dtype=i32, device=device),
            torch.zeros(extent, dtype=i32, device=device),
            torch.zeros(extent, dtype=torch.bool, device=device),
            torch.tensor(max_stuff, dtype=i32, device=device))


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
                     rel_origin: Sequence[int]) -> PanopticGlobalDense:
    """Direct-substitute fusion of a fragment's final TSDF + panoptic
    segment window into the global map, in place (reference gru_fusion.py
    direct mode). tsdf_window / cur_mask / seg_window: [X, Y, Z]."""
    window = tuple(tsdf_window.shape)
    g_tsdf = slice_window(gmap.tsdf, rel_origin, window)
    g_mask = slice_window(gmap.mask, rel_origin, window)
    g_inst = slice_window(gmap.instance, rel_origin, window)
    g_sem = slice_window(gmap.semantic, rel_origin, window)

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

    update_window(gmap.tsdf, fused_tsdf, rel_origin)
    update_window(gmap.instance, new_inst.int(), rel_origin)
    update_window(gmap.semantic, new_sem.int(), rel_origin)
    update_window(gmap.mask, union, rel_origin)
    gmap.next_instance_id = next_id
    return gmap
