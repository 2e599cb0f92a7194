"""Synthetic posed-RGBD scenes and fragments for smoke runs, tests, the
training step and the on-disk ScanNet-layout trees of
tools/make_synthetic_scannet.py (own copy of eprecon_tpu/data/synthetic.py).

Rooms with a floor and a few boxes (and doorway walls between rooms),
optionally textured, cameras on arcs looking at each room's centre, depth, images and per-pixel labels rendered analytically by ray
casting in numpy; the GT TSDF at three pyramid levels is fused from the
depths with ops/tsdf_fusion.py (plain torch on the CPU), the voxel labels
come from the boxes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from eprecon_tpu_torch.ops import camera as cam
from eprecon_tpu_torch.ops import tsdf_fusion

FLOOR_CLASS = 2               # nyu40 floor
THING_CLASSES = [4, 5, 6, 7]  # bed, chair, sofa, table
WALL_CLASS = 1                # nyu40 wall


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
    # world-anchored albedo (photoconsistent across views): uniform
    # surfaces leave the cross-view feature variance, EPRecon's occupancy
    # cue (reference occupancy_initialization.py:126-128), blind; real
    # ScanNet surfaces are textured, so the on-disk trees are too
    textured: bool = False

    def __post_init__(self):
        if self.floor_color is None:
            self.floor_color = np.array([120.0, 120.0, 120.0])


def _albedo_texture(pts: np.ndarray) -> np.ndarray:
    """Multiplicative albedo in [0.55, 1.45] from world position: an 8 cm
    checker plus two incommensurate sinusoid bands."""
    c = np.floor(pts / 0.08).sum(axis=1) % 2.0
    s1 = np.sin(pts[:, 0] * 23.0 + pts[:, 1] * 17.0 + pts[:, 2] * 11.0)
    s2 = np.sin(pts[:, 0] * 5.3 - pts[:, 1] * 7.1 + pts[:, 2] * 3.7)
    return 1.0 + 0.30 * (c - 0.5) + 0.15 * s1 + 0.15 * s2


def make_scene(seed: int = 0, n_boxes: int = 3, extent: float = 3.0,
               n_rooms: int = 1, room_pitch: float = 4.0,
               textured: bool = False) -> Scene:
    """n_rooms > 1 lays out `n_boxes` things per room along +x, with a
    doorway-gapped dividing wall (class 1 stuff) between adjacent rooms:
    scenes larger than one fragment window."""
    rng = np.random.default_rng(seed)
    boxes = []
    inst = 3
    for room in range(n_rooms):
        cx = room * room_pitch
        for _ in range(n_boxes):
            center = rng.uniform(-extent / 2 + 0.6, extent / 2 - 0.6, 3)
            center[0] += cx
            size = rng.uniform(0.3, 0.9, 3)
            lo = center - size / 2
            hi = center + size / 2
            lo[2] = 0.0
            hi[2] = max(hi[2], 0.3)
            boxes.append(Box(lo, hi, int(rng.choice(THING_CLASSES)), inst,
                             rng.uniform(40, 230, 3)))
            inst += 1
        if room + 1 < n_rooms:
            # dividing wall at x = cx + pitch/2, 1 m doorway at y in [-0.5, 0.5]
            wx = cx + room_pitch / 2
            for ylo, yhi in ((-extent, -0.5), (0.5, extent)):
                boxes.append(Box(np.array([wx - 0.05, ylo, 0.0]),
                                 np.array([wx + 0.05, yhi, 2.2]), WALL_CLASS,
                                 WALL_CLASS, np.array([200.0, 200.0, 200.0])))
    return Scene(boxes, textured=textured)


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
    """Analytic ray cast. Returns (depth [H, W] m, rgb [H, W, 3] BGR float,
    semantic [H, W] nyu40 id, instance [H, W] id; 0 where depth is 0)."""
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
    sem = np.zeros(dirs.shape[0], np.int32)
    ins = np.zeros(dirs.shape[0], np.int32)
    rgb[best_obj == -2] = scene.floor_color
    sem[best_obj == -2] = FLOOR_CLASS
    ins[best_obj == -2] = FLOOR_CLASS  # stuff instance id = class id
    for bi, box in enumerate(scene.boxes):
        rgb[best_obj == bi] = box.color
        sem[best_obj == bi] = box.cls
        ins[best_obj == bi] = box.instance
    if scene.textured:
        hit = best_obj != -1
        pts = origins[hit] + best_t[hit, None] * dirs[hit]
        rgb[hit] = np.clip(rgb[hit] * _albedo_texture(pts)[:, None], 0, 255)
    rgb[best_obj == -1] = 30.0
    sem[z <= 0] = 0
    ins[z <= 0] = 0
    return (z.reshape(h, w).astype(np.float32),
            rgb.reshape(h, w, 3).astype(np.float32),
            sem.reshape(h, w), ins.reshape(h, w))


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


def walkthrough_poses(n_views: int, n_rooms: int, room_pitch: float = 4.0,
                      radius: float = 2.2, height: float = 1.4) -> np.ndarray:
    """Room-by-room trajectory: a full orbit inside each room in turn, so
    fragments cross room boundaries mid-scene."""
    per = n_views // n_rooms
    chunks = []
    for r in range(n_rooms):
        n = per if r + 1 < n_rooms else n_views - per * (n_rooms - 1)
        chunks.append(orbit_poses(
            n, radius=radius, height=height, start=0.3 * r,
            sweep=2 * np.pi * (n - 1) / max(n, 1),
            center=(r * room_pitch, 0.0)))
    return np.concatenate(chunks)


def voxel_labels(scene: Scene, origin: np.ndarray, voxel_size: float,
                 dim: Tuple[int, int, int]):
    """Semantic / instance ids of the voxels near each object's surface:
    a band around the floor, each box grown by 1.5 voxels (later boxes
    win)."""
    axes = [origin[i] + voxel_size * (np.arange(dim[i]) + 0.5) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    sem = np.zeros(dim, np.int32)
    ins = np.zeros(dim, np.int32)
    near_floor = np.abs(pts[..., 2] - scene.floor_z) < 1.5 * voxel_size
    sem[near_floor] = FLOOR_CLASS
    ins[near_floor] = FLOOR_CLASS
    for box in scene.boxes:
        m = 1.5 * voxel_size
        inside = ((pts >= box.lo - m) & (pts <= box.hi + m)).all(axis=-1)
        sem[inside] = box.cls
        ins[inside] = box.instance
    return sem, ins


def make_fragment(n_views: int = 9, image_hw: Tuple[int, int] = (480, 640),
                  n_vox: Tuple[int, int, int] = (96, 96, 96),
                  voxel_size: float = 0.04, seed: int = 0,
                  start_angle: float = 0.0,
                  scene: Optional[Scene] = None) -> Dict[str, np.ndarray]:
    """One fragment: BGR images, depths, poses, per-scale projections, the
    fragment origin, the aligned-camera transform and the GT: tsdf_levels /
    occ_levels (finest first, 3 levels), semantic and instance [n_vox]
    (only where the finest level is occupied)."""
    if scene is None:
        scene = make_scene(seed)
    h, w = image_hw
    f = 0.9 * w / 2
    intr = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)
    poses = orbit_poses(n_views, start=start_angle)
    views = [render_view(scene, intr, poses[v], image_hw) for v in range(n_views)]
    depths = np.stack([v[0] for v in views])
    imgs = np.stack([v[1] for v in views])

    # fragment origin: the view-centroid window, snapped to 8 voxels
    centers = poses[:, :3, 3].mean(0)
    half = np.array(n_vox) * voxel_size / 2
    origin = np.array([centers[0] - half[0], centers[1] - half[1], -0.2])
    origin = (np.round(origin / (voxel_size * 8)) * (voxel_size * 8)
              ).astype(np.float32)
    intrinsics = np.stack([intr] * n_views)

    # GT TSDF at 3 pyramid levels (reference datasets/transforms.py:281-298)
    tsdf_levels, occ_levels = [], []
    for lvl in range(3):
        t, wt = tsdf_fusion.fuse_frames(
            torch.from_numpy(depths), torch.from_numpy(intrinsics),
            torch.from_numpy(poses), torch.from_numpy(origin),
            tuple(v // 2 ** lvl for v in n_vox), voxel_size * 2 ** lvl,
            margin=3)
        tsdf_levels.append(t.numpy())
        occ_levels.append(tsdf_fusion.occupancy_from_tsdf(t, wt).numpy())
    sem_vol, ins_vol = voxel_labels(scene, origin, voxel_size, n_vox)
    return dict(
        imgs=imgs, depths=depths, intrinsics=intrinsics, poses=poses,
        vol_origin_partial=origin,
        tsdf_levels=tsdf_levels, occ_levels=occ_levels,
        semantic=np.where(occ_levels[0], sem_vol, 0),
        instance=np.where(occ_levels[0], ins_vol, 0),
        proj_matrices=cam.projection_matrices(intrinsics, poses, stride=4,
                                              n_scales=3),
        world_to_aligned_camera=cam.world_to_aligned_camera(
            poses[n_views // 2].astype(np.float64)),
        scene_seed=seed)
