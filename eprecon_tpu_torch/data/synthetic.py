"""Synthetic posed-RGB fragments for smoke runs and tests (own copy of the
inference inputs of eprecon_tpu/data/synthetic.py:230 make_fragment).

A room with a floor and a few boxes, cameras on an arc looking at its
centre, images rendered analytically by ray casting, all in numpy. The GT
TSDF / label volumes of the JAX version feed training and come with the
training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from eprecon_tpu_torch.ops import camera as cam

THING_CLASSES = [4, 5, 6, 7]  # bed, chair, sofa, table


@dataclass
class Box:
    lo: np.ndarray      # [3]
    hi: np.ndarray      # [3]
    cls: int
    instance: int
    color: np.ndarray   # [3] 0..255


@dataclass
class Scene:
    boxes: List[Box]
    floor_z: float = 0.0
    floor_color: np.ndarray = None

    def __post_init__(self):
        if self.floor_color is None:
            self.floor_color = np.array([120.0, 120.0, 120.0])


def make_scene(seed: int = 0, n_boxes: int = 3, extent: float = 3.0) -> Scene:
    rng = np.random.default_rng(seed)
    boxes = []
    for inst in range(3, 3 + n_boxes):
        center = rng.uniform(-extent / 2 + 0.6, extent / 2 - 0.6, 3)
        size = rng.uniform(0.3, 0.9, 3)
        lo = center - size / 2
        hi = center + size / 2
        lo[2] = 0.0
        hi[2] = max(hi[2], 0.3)
        boxes.append(Box(lo, hi, int(rng.choice(THING_CLASSES)), inst,
                         rng.uniform(40, 230, 3)))
    return Scene(boxes)


def _ray_box(origins, dirs, lo, hi):
    """Ray/AABB slab test. origins, dirs [N, 3] -> t (np.inf on a miss)."""
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    t0 = (lo[None, :] - origins) * inv
    t1 = (hi[None, :] - origins) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    hit = tmax >= np.maximum(tmin, 1e-4)
    t = np.where(tmin > 1e-4, tmin, tmax)
    return np.where(hit & (t > 1e-4), t, np.inf)


def render_view(scene: Scene, intr: np.ndarray, pose: np.ndarray,
                hw: Tuple[int, int], max_depth: float = 4.0):
    """Analytic ray cast. Returns (depth [H, W] m, rgb [H, W, 3] BGR float)."""
    h, w = hw
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack([(xs - intr[0, 2]) / intr[0, 0],
                         (ys - intr[1, 2]) / intr[1, 1],
                         np.ones_like(xs, np.float64)], axis=-1).reshape(-1, 3)
    o = pose[:3, 3]
    dirs = dirs_cam @ pose[:3, :3].T
    origins = np.broadcast_to(o, dirs.shape)

    best_t = np.full(dirs.shape[0], np.inf)
    best_obj = np.full(dirs.shape[0], -1, np.int32)  # -1 none, -2 floor
    dz = dirs[:, 2]
    t_floor = np.where(np.abs(dz) > 1e-9, (scene.floor_z - o[2]) / dz, np.inf)
    ok = (t_floor > 1e-4) & np.isfinite(t_floor)
    best_t = np.where(ok, t_floor, best_t)
    best_obj = np.where(ok, -2, best_obj)
    for bi, box in enumerate(scene.boxes):
        t = _ray_box(origins, dirs, box.lo, box.hi)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_obj = np.where(closer, bi, best_obj)

    z = best_t * dirs_cam[:, 2]
    z = np.where(np.isfinite(z) & (z <= max_depth), z, 0.0)
    rgb = np.zeros((dirs.shape[0], 3))
    rgb[best_obj == -2] = scene.floor_color
    for bi, box in enumerate(scene.boxes):
        rgb[best_obj == bi] = box.color
    rgb[best_obj == -1] = 30.0
    return (z.reshape(h, w).astype(np.float32),
            rgb.reshape(h, w, 3).astype(np.float32))


def orbit_poses(n_views: int, radius: float = 2.2, height: float = 1.4,
                start: float = 0.0, sweep: float = 1.2,
                center=(0.0, 0.0)) -> np.ndarray:
    """Camera-to-world poses on an arc looking at the scene centre."""
    poses = []
    for i in range(n_views):
        a = start + sweep * i / max(n_views - 1, 1)
        eye = np.array([center[0] + radius * np.cos(a),
                        center[1] + radius * np.sin(a), height])
        fwd = np.array([center[0], center[1], 0.4]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        pose = np.eye(4)
        pose[:3, 0] = right
        pose[:3, 1] = np.cross(fwd, right)
        pose[:3, 2] = fwd
        pose[:3, 3] = eye
        poses.append(pose)
    return np.stack(poses).astype(np.float32)


def make_fragment(n_views: int = 9, image_hw: Tuple[int, int] = (480, 640),
                  n_vox: Tuple[int, int, int] = (96, 96, 96),
                  voxel_size: float = 0.04, seed: int = 0,
                  start_angle: float = 0.0,
                  scene: Optional[Scene] = None) -> Dict[str, np.ndarray]:
    """One fragment: BGR images, poses, per-scale projections, the
    fragment origin and the aligned-camera transform."""
    if scene is None:
        scene = make_scene(seed)
    h, w = image_hw
    f = 0.9 * w / 2
    intr = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)
    poses = orbit_poses(n_views, start=start_angle)
    views = [render_view(scene, intr, poses[v], image_hw) for v in range(n_views)]
    depths = np.stack([d for d, _ in views])
    imgs = np.stack([rgb for _, rgb in views])

    # fragment origin: the view-centroid window, snapped to 8 voxels
    centers = poses[:, :3, 3].mean(0)
    half = np.array(n_vox) * voxel_size / 2
    origin = np.array([centers[0] - half[0], centers[1] - half[1], -0.2])
    origin = (np.round(origin / (voxel_size * 8)) * (voxel_size * 8)
              ).astype(np.float32)
    intrinsics = np.stack([intr] * n_views)
    return dict(
        imgs=imgs, depths=depths, intrinsics=intrinsics, poses=poses,
        vol_origin_partial=origin,
        proj_matrices=cam.projection_matrices(intrinsics, poses, stride=4,
                                              n_scales=3),
        world_to_aligned_camera=cam.world_to_aligned_camera(
            poses[n_views // 2].astype(np.float64)),
        scene_seed=seed)
