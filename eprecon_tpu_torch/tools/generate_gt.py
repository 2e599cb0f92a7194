"""Offline GT generation: full-scene TSDF fusion, label voxelization and
fragment assembly (port of eprecon_tpu/tools/generate_gt.py).

Reference: tools/tsdf_fusion/generate_gt.py — per scene: 3-level full-scene
TSDF fusion (reference :117-183, pycuda kernel), panoptic point-label
voxelization by bincount majority vote (:77-114,185-227), keyframe selection
(:243-307), split pkl assembly (:352-374). The fusion is the port's
ops/tsdf_fusion on a device (CUDA unless the caller passes the CPU), the
same code the online data pipeline runs. The output tree (file names,
arrays, pkl schema) is the JAX tool's.

CLI:
  python -m eprecon_tpu_torch.tools.generate_gt --data_path <root>/scans \\
      [--save_name all_tsdf_9] [--label_path <root>/labels] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from eprecon_tpu_torch.device import DeviceLike, resolve_device


def scene_bounds(depth_list, cam_intr_list, cam_pose_list,
                 max_depth: float = 3.0) -> np.ndarray:
    """World-space AABB [3, 2] covering all view frusta (reference
    :128-142)."""
    from eprecon_tpu_torch.data.transforms import get_view_frustum

    bnds = np.stack([np.full(3, np.inf), np.full(3, -np.inf)], axis=1)
    for d, k, p in zip(depth_list, cam_intr_list, cam_pose_list):
        if not np.isfinite(p).all():
            continue
        pts = get_view_frustum(max_depth, d.shape, k, p)
        bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(1))
        bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(1))
    return bnds


def fuse_scene(depths: Sequence[np.ndarray], intrinsics: Sequence[np.ndarray],
               poses: Sequence[np.ndarray], voxel_size: float = 0.04,
               n_layers: int = 3, margin: int = 3, max_chunk: int = 64,
               device: DeviceLike = None
               ) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Full-scene TSDF at `n_layers` pyramid levels, fused on `device`
    (CUDA unless the caller passes the CPU), frames moved in chunks of
    `max_chunk`. Returns (tsdf_list, weight_list, vol_origin) as numpy."""
    from eprecon_tpu_torch.ops import tsdf_fusion

    device = resolve_device(device)
    bnds = scene_bounds(depths, intrinsics, poses)
    origin = bnds[:, 0].astype(np.float32)
    to_dev = lambda xs: torch.from_numpy(np.stack(xs).astype(np.float32)).to(device)
    tsdfs, weights = [], []
    for lvl in range(n_layers):
        vsz = voxel_size * 2 ** lvl
        dim = tuple(int(np.ceil((bnds[i, 1] - bnds[i, 0]) / vsz))
                    for i in range(3))
        vol = tsdf_fusion.make_volume(dim, origin, vsz, margin, device)
        for c0 in range(0, len(depths), max_chunk):
            c1 = min(c0 + max_chunk, len(depths))
            for d, k, p in zip(to_dev(depths[c0:c1]), to_dev(intrinsics[c0:c1]),
                               to_dev(poses[c0:c1])):
                vol = vol.integrate(d, k, p)
        tsdfs.append(vol.tsdf.cpu().numpy())
        weights.append(vol.weight.cpu().numpy())
    return tsdfs, weights, origin


def voxelize_labels(points: np.ndarray, labels: np.ndarray, origin: np.ndarray,
                    voxel_size: float, dim: Tuple[int, int, int]) -> np.ndarray:
    """Majority-vote label per voxel from labeled points
    (reference generate_gt.py:77-114 np.bincount vote)."""
    idx = np.floor((points - origin) / voxel_size).astype(np.int64)
    inb = ((idx >= 0) & (idx < np.array(dim))).all(axis=1)
    idx = idx[inb]
    lab = labels[inb].astype(np.int64)
    flat = (idx[:, 0] * dim[1] + idx[:, 1]) * dim[2] + idx[:, 2]
    n = dim[0] * dim[1] * dim[2]
    max_lab = int(lab.max()) + 1 if len(lab) else 1
    counts = np.bincount(flat * max_lab + lab, minlength=n * max_lab)
    counts = counts.reshape(n, max_lab)
    out = counts.argmax(axis=1)
    out[counts.sum(axis=1) == 0] = 0
    return out.reshape(dim).astype(np.int32)


def interpolate_labels(volume: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Fill zero-label voxels from nearest labeled neighbors
    (reference datasets/scannet/label_interpolate.py:6-48)."""
    from scipy.interpolate import NearestNDInterpolator

    filled = volume.copy()
    src = np.argwhere(valid & (volume > 0))
    if len(src) == 0:
        return filled
    interp = NearestNDInterpolator(src, volume[tuple(src.T)])
    dst = np.argwhere(valid & (volume == 0))
    if len(dst):
        filled[tuple(dst.T)] = interp(dst)
    return filled


def process_scene(scene: str, frames: Dict, save_path: str,
                  voxel_size: float = 0.04, n_views: int = 9,
                  label_points: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                  device: DeviceLike = None):
    """Fuse one scene and write full_tsdf_layer{l}.npz (+ labels),
    tsdf_info.npz and its fragment metas (reference generate_gt.py:311-349).
    Returns the metas."""
    from eprecon_tpu_torch.tools.keyframes import build_fragments, select_keyframes

    os.makedirs(os.path.join(save_path, scene), exist_ok=True)
    tsdfs, _, origin = fuse_scene(frames["depths"], frames["intrinsics"],
                                  frames["poses"], voxel_size, device=device)
    for lvl, t in enumerate(tsdfs):
        np.savez_compressed(
            os.path.join(save_path, scene, f"full_tsdf_layer{lvl}.npz"), t)
    # scene frame metadata (reference writes tsdf_info.pkl, generate_gt.py:172)
    np.savez(os.path.join(save_path, scene, "tsdf_info.npz"),
             vol_origin=origin.astype(np.float32),
             voxel_size=np.float32(voxel_size))
    if label_points is not None:
        pts, sem, ins = label_points
        occ0 = np.abs(tsdfs[0]) < 0.999
        for name, lab in (("semantic", sem), ("instance", ins)):
            vol = voxelize_labels(pts, lab, origin, voxel_size, tsdfs[0].shape)
            np.savez_compressed(
                os.path.join(save_path, scene, f"full_{name}_layer0.npz"), vol)
            np.savez_compressed(
                os.path.join(save_path, scene,
                             f"full_{name}_layer_interpolate0.npz"),
                interpolate_labels(vol, occ0))
    kf = select_keyframes(frames["poses"])
    # keyframe indices (into the kept-pose list) back to on-disk frame ids,
    # so fragments name the right color/depth files when bad-pose frames
    # were dropped
    kf_ids = [frames["frame_ids"][i] for i in kf] if "frame_ids" in frames else kf
    frags = build_fragments(scene, kf_ids, origin, n_views)
    with open(os.path.join(save_path, scene, "fragments.pkl"), "wb") as f:
        pickle.dump(frags, f)
    return frags


def generate_split_pkls(save_path: str, splits: Dict[str, List[str]]):
    """Assemble fragments_{split}.pkl (reference generate_gt.py:352-374)."""
    for split, scenes in splits.items():
        all_frags = []
        for scene in scenes:
            p = os.path.join(save_path, scene, "fragments.pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    all_frags.extend(pickle.load(f))
        with open(os.path.join(save_path, f"fragments_{split}.pkl"), "wb") as f:
            pickle.dump(all_frags, f)


def load_label_points(label_path: str, scene: str):
    """The ScanNet label export ({scene}_vert.npy xyzrgb + _sem_label.npy +
    _ins_label.npy, reference datasets/scannet/batch_load_scannet_data.py
    outputs): (points, semantic, instance), or None."""
    vert = os.path.join(label_path, f"{scene}_vert.npy")
    if not os.path.exists(vert):
        return None
    pts = np.load(vert)[:, :3].astype(np.float32)
    sem = np.load(os.path.join(label_path, f"{scene}_sem_label.npy"))
    ins = np.load(os.path.join(label_path, f"{scene}_ins_label.npy"))
    return pts, sem, ins


def generate_all(data_path: str, save_name: str = "all_tsdf_9",
                 voxel_size: float = 0.04, n_views: int = 9,
                 max_depth: float = 3.0, label_path: Optional[str] = None,
                 splits: Optional[Dict[str, List[str]]] = None,
                 device: DeviceLike = None) -> str:
    """Process every scene under data_path (fusion on `device`) and
    assemble the split pkls beside it, in <data_path>/../<save_name>.
    Returns that directory."""
    from eprecon_tpu_torch.tools.simple_loader import ScanNetSceneLoader

    save_path = os.path.join(os.path.dirname(data_path.rstrip("/")), save_name)
    scenes = sorted(os.listdir(data_path))
    for scene in scenes:
        t0 = time.perf_counter()
        frames = ScanNetSceneLoader(data_path, scene, max_depth).load_all()
        labels = load_label_points(label_path, scene) if label_path else None
        frags = process_scene(scene, frames, save_path, voxel_size, n_views,
                              label_points=labels, device=device)
        print(f"{scene}: done, {len(frames['depths'])} frames, "
               f"{len(frags)} fragments in {time.perf_counter() - t0:.2f} s")
    if splits is None:
        splits = {"train": scenes, "val": scenes, "test": scenes}
    generate_split_pkls(save_path, splits)
    return save_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--save_name", default="all_tsdf_9")
    ap.add_argument("--voxel_size", type=float, default=0.04)
    ap.add_argument("--n_views", type=int, default=9)
    ap.add_argument("--max_depth", type=float, default=3.0)
    ap.add_argument("--label_path", default=None,
                    help="dir with {scene}_vert.npy label exports")
    ap.add_argument("--device", default=None,
                    help="torch device of the fusion (default: CUDA, which "
                         "must exist)")
    args = ap.parse_args(argv)
    generate_all(args.data_path, args.save_name, args.voxel_size,
                 args.n_views, args.max_depth, args.label_path,
                 device=args.device)


if __name__ == "__main__":
    main()
