"""The traffic generator's scenes: textured rooms with a floor and boxes,
cameras walking from room to room, depth, colour and labels ray-cast on
the device, and the fragments' inputs and ground truth.

A frozen copy of the port's synthetic data (`data/synthetic.py`: scene
layout, albedo texture, slab test, orbit poses, voxel labels; `ops/
camera.py`: projection matrices and the aligned-camera transform; `ops/
tsdf_fusion.py`: the GT fusion), with the ray cast and the fusion written
for torch tensors on one device, all views at once, so that a pool of
full-size fragments is made on the card in well under a second.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FLOOR_CLASS = 2               # nyu40 floor
THING_CLASSES = [4, 5, 6, 7]  # bed, chair, sofa, table
WALL_CLASS = 1                # nyu40 wall
SKY = 30.0                    # colour where a ray hits nothing


@dataclass
class Scene:
    lo: np.ndarray        # [N, 3] box corners
    hi: np.ndarray        # [N, 3]
    cls: np.ndarray       # [N] nyu40 ids
    instance: np.ndarray  # [N]
    color: np.ndarray     # [N, 3] BGR 0..255
    floor_color: float = 120.0


def make_scene(rng: np.random.Generator, rooms: int, boxes_per_room: int,
               extent: float, room_pitch: float) -> Scene:
    """`boxes_per_room` things per room along +x, a doorway-gapped wall
    between adjacent rooms (data/synthetic.make_scene's layout)."""
    lo, hi, cls, inst, col = [], [], [], [], []
    nxt = 3
    for room in range(rooms):
        cx = room * room_pitch
        for _ in range(boxes_per_room):
            center = rng.uniform(-extent / 2 + 0.6, extent / 2 - 0.6, 3)
            center[0] += cx
            size = rng.uniform(0.3, 0.9, 3)
            a, b = center - size / 2, center + size / 2
            a[2] = 0.0
            b[2] = max(b[2], 0.3)
            lo.append(a), hi.append(b)
            cls.append(int(rng.choice(THING_CLASSES)))
            inst.append(nxt)
            col.append(rng.uniform(40, 230, 3))
            nxt += 1
        if room + 1 < rooms:
            wx = cx + room_pitch / 2
            for ylo, yhi in ((-extent, -0.5), (0.5, extent)):
                lo.append(np.array([wx - 0.05, ylo, 0.0]))
                hi.append(np.array([wx + 0.05, yhi, 2.2]))
                cls.append(WALL_CLASS), inst.append(WALL_CLASS)
                col.append(np.array([200.0, 200.0, 200.0]))
    return Scene(np.stack(lo), np.stack(hi), np.array(cls, np.int32),
                 np.array(inst, np.int32), np.stack(col))


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose at `eye` looking at `target` (orbit_poses)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = np.cross(fwd, right)
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose


def walkthrough(n_fragments: int, views: int, rooms: int, room_pitch: float,
                radius: float, height: float, start: float) -> np.ndarray:
    """Poses [n_fragments, views, 4, 4]: a full orbit inside each room in
    turn, fragments of `views` consecutive keyframes."""
    per_room = [n_fragments // rooms + (r < n_fragments % rooms)
                for r in range(rooms)]
    out = []
    for r, n in enumerate(per_room):
        total = n * views
        for i in range(total):
            a = start + 0.3 * r + 2 * np.pi * i / total
            c = np.array([r * room_pitch, 0.0])
            eye = np.array([c[0] + radius * np.cos(a),
                            c[1] + radius * np.sin(a), height])
            out.append(look_at(eye, np.array([c[0], c[1], 0.4])))
    return np.stack(out).reshape(n_fragments, views, 4, 4).astype(np.float32)


def intrinsics(hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    f = 0.9 * w / 2
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)


def _albedo(pts: torch.Tensor) -> torch.Tensor:
    c = torch.floor(pts / 0.08).sum(-1) % 2.0
    s1 = torch.sin(pts[..., 0] * 23.0 + pts[..., 1] * 17.0 + pts[..., 2] * 11.0)
    s2 = torch.sin(pts[..., 0] * 5.3 - pts[..., 1] * 7.1 + pts[..., 2] * 3.7)
    return 1.0 + 0.30 * (c - 0.5) + 0.15 * s1 + 0.15 * s2


def render(scene: Scene, intr: np.ndarray, poses: np.ndarray,
           hw: Tuple[int, int], device, max_depth: float = 4.0):
    """Ray cast every view at once: (depth [V, H, W] m, BGR [V, H, W, 3]
    f32, semantic, instance [V, H, W] int32), textured surfaces."""
    h, w = hw
    f32 = dict(dtype=torch.float32, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32),
                            indexing="ij")
    dc = torch.stack([(xs - float(intr[0, 2])) / float(intr[0, 0]),
                      (ys - float(intr[1, 2])) / float(intr[1, 1]),
                      torch.ones_like(xs)], -1).reshape(-1, 3)
    pz = torch.as_tensor(poses, **f32)
    dirs = torch.einsum("nj,vij->vni", dc, pz[:, :3, :3])      # [V, N, 3]
    o = pz[:, None, :3, 3]                                      # [V, 1, 3]
    inf = torch.tensor(float("inf"), **f32)
    dz = dirs[..., 2]
    t_floor = torch.where(dz.abs() > 1e-9, (0.0 - o[..., 2]) / dz, inf)
    ok = (t_floor > 1e-4) & torch.isfinite(t_floor)
    best_t = torch.where(ok, t_floor, inf)
    best = torch.where(ok, -2, -1).to(torch.int32)
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    lo = torch.as_tensor(scene.lo, **f32)
    hi = torch.as_tensor(scene.hi, **f32)
    for bi in range(lo.shape[0]):
        t0 = (lo[bi] - o) * inv
        t1 = (hi[bi] - o) * inv
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = tmax >= tmin.clamp(min=1e-4)
        t = torch.where(tmin > 1e-4, tmin, tmax)
        t = torch.where(hit & (t > 1e-4), t, inf)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best = torch.where(closer, bi, best)
    z = best_t * dc[None, :, 2]
    z = torch.where(torch.isfinite(z) & (z <= max_depth), z, 0.0)
    table_col = torch.cat([torch.full((1, 3), scene.floor_color, **f32),
                           torch.as_tensor(scene.color, **f32)])
    i32 = dict(dtype=torch.int32, device=device)
    table_sem = torch.cat([torch.tensor([FLOOR_CLASS], **i32),
                           torch.as_tensor(scene.cls, **i32)])
    table_ins = torch.cat([torch.tensor([FLOOR_CLASS], **i32),
                           torch.as_tensor(scene.instance, **i32)])
    idx = (best + 1).clamp(min=0).long()          # floor -> 0, box b -> b + 1
    hit = best != -1
    rgb = table_col[idx]
    pts = o + best_t.nan_to_num(posinf=0.0)[..., None] * dirs
    rgb = torch.where(hit[..., None],
                      (rgb * _albedo(pts)[..., None]).clamp(0, 255), SKY)
    sem = torch.where(hit & (z > 0), table_sem[idx], 0)
    ins = torch.where(hit & (z > 0), table_ins[idx], 0)
    v = poses.shape[0]
    return (z.reshape(v, h, w), rgb.reshape(v, h, w, 3), sem.reshape(v, h, w),
            ins.reshape(v, h, w))


def fragment_origin(poses: np.ndarray, n_vox: Sequence[int],
                    voxel_size: float) -> np.ndarray:
    """The view-centroid window, snapped to 8 voxels (make_fragment)."""
    centers = poses[:, :3, 3].mean(0)
    half = np.array(n_vox) * voxel_size / 2
    origin = np.array([centers[0] - half[0], centers[1] - half[1], -0.2])
    return (np.round(origin / (voxel_size * 8)) * (voxel_size * 8)
            ).astype(np.float32)


def projection_matrices(intr: np.ndarray, poses: np.ndarray, stride: int = 4,
                        n_scales: int = 3) -> np.ndarray:
    """[V, n_scales, 4, 4] world->pixel (ops/camera.projection_matrices)."""
    world2cam = np.linalg.inv(poses)
    intr = np.broadcast_to(intr, (poses.shape[0], 3, 3))
    mats = []
    for s in range(n_scales):
        k = np.asarray(intr, np.float64).copy()
        k[..., :2, :] /= stride * 2 ** s
        proj = world2cam.copy()
        proj[:, :3, :4] = np.einsum("vij,vjk->vik", k, world2cam[:, :3, :4])
        mats.append(proj)
    return np.stack(mats, axis=1).astype(np.float32)


def _axangle(axis: np.ndarray, theta: float) -> np.ndarray:
    x, y, z = axis
    c, s = np.cos(theta), np.sin(theta)
    C = 1.0 - c
    return np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]])


def world_to_aligned_camera(middle_pose: np.ndarray) -> np.ndarray:
    """World -> gravity-aligned middle-camera frame (ops/camera.py)."""
    world2cam = np.linalg.inv(middle_pose)
    z_c = (world2cam @ np.array([0.0, 0.0, 1.0, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0.0, -1.0, 0.0]))
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    theta = np.arccos(np.clip(-z_c[1] / (np.linalg.norm(z_c) + 1e-12), -1, 1))
    rot4 = np.eye(4)
    rot4[:3, :3] = _axangle(axis, theta)
    return (rot4 @ world2cam).astype(np.float32)


def _dense_coords(dim, device) -> torch.Tensor:
    axes = [torch.arange(d, device=device) for d in dim]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def fuse_tsdf(depths: torch.Tensor, intr: np.ndarray, poses: np.ndarray,
              origin: np.ndarray, dim: Sequence[int], voxel_size: float,
              margin: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT TSDF of the views in a fresh volume (ops/tsdf_fusion.fuse_frames:
    nearest-pixel depth, truncation, running weighted mean): (tsdf,
    occupancy) [X, Y, Z]."""
    dev = depths.device
    im_h, im_w = depths.shape[1:]
    trunc = margin * voxel_size
    world = (torch.as_tensor(origin, device=dev)
             + voxel_size * _dense_coords(dim, dev).reshape(-1, 3).float())
    n = world.shape[0]
    t, wt = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    k = torch.as_tensor(intr, dtype=torch.float32, device=dev)
    w2c = torch.linalg.inv(torch.as_tensor(poses, dtype=torch.float32,
                                           device=dev))
    for v in range(depths.shape[0]):
        cam = world @ w2c[v, :3, :3].T + w2c[v, :3, 3]
        z = cam[:, 2]
        sz = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        px = torch.round(cam[:, 0] * k[0, 0] / sz + k[0, 2]).long()
        py = torch.round(cam[:, 1] * k[1, 1] / sz + k[1, 2]).long()
        inb = (px >= 0) & (px < im_w) & (py >= 0) & (py < im_h) & (z > 0)
        d = depths[v][py.clamp(0, im_h - 1), px.clamp(0, im_w - 1)]
        diff = d - z
        dist = torch.clamp(diff / trunc, max=1.0)
        ok = inb & (d > 0) & (diff >= -trunc)
        w_new = wt + 1.0
        t = torch.where(ok, (wt * t + dist) / w_new, t)
        wt = torch.where(ok, w_new, wt)
    t, wt = t.reshape(*dim), wt.reshape(*dim)
    return t, (t < 0.999) & (t > -0.999) & (wt > 1.0)


def voxel_labels(scene: Scene, origin: np.ndarray, voxel_size: float,
                 dim: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semantic / instance ids near each surface: a floor band, each box
    grown by 1.5 voxels, later boxes winning (data/synthetic.voxel_labels)."""
    pts = (torch.as_tensor(origin, device=device)
           + voxel_size * (_dense_coords(dim, device).float() + 0.5))
    sem = torch.zeros(tuple(dim), dtype=torch.int32, device=device)
    ins = torch.zeros_like(sem)
    near = (pts[..., 2] - 0.0).abs() < 1.5 * voxel_size
    sem[near] = FLOOR_CLASS
    ins[near] = FLOOR_CLASS
    m = 1.5 * voxel_size
    for b in range(scene.lo.shape[0]):
        lo = torch.as_tensor(scene.lo[b] - m, dtype=torch.float32, device=device)
        hi = torch.as_tensor(scene.hi[b] + m, dtype=torch.float32, device=device)
        inside = ((pts >= lo) & (pts <= hi)).all(-1)
        sem[inside] = int(scene.cls[b])
        ins[inside] = int(scene.instance[b])
    return sem, ins


def make_fragment(scene: Scene, poses: np.ndarray, hw: Tuple[int, int],
                  n_vox: Sequence[int], voxel_size: float, device,
                  with_gt: bool) -> Dict[str, object]:
    """One fragment's program inputs (images [V, H, W, 3] BGR f32 on
    `device`, projections, origin, aligned-camera transform) and, with
    `with_gt`, its GT: tsdf / occupancy at 3 levels (finest first) and
    semantic / instance ids where the finest level is occupied."""
    intr = intrinsics(hw)
    depths, rgb, _, _ = render(scene, intr, poses, hw, device)
    origin = fragment_origin(poses, n_vox, voxel_size)
    out: Dict[str, object] = dict(
        imgs=rgb, vol_origin_partial=origin,
        proj_matrices=projection_matrices(intr, poses),
        world_to_aligned_camera=world_to_aligned_camera(
            poses[poses.shape[0] // 2].astype(np.float64)))
    if with_gt:
        tsdf, occ = [], []
        for lvl in range(3):
            t, o = fuse_tsdf(depths, intr, poses, origin,
                             [v // 2 ** lvl for v in n_vox],
                             voxel_size * 2 ** lvl)
            tsdf.append(t)
            occ.append(o)
        sem, ins = voxel_labels(scene, origin, voxel_size, n_vox, device)
        out.update(tsdf_levels=tsdf, occ_levels=occ,
                   semantic=torch.where(occ[0], sem, 0),
                   instance=torch.where(occ[0], ins, 0))
    return out


def snapped_anchor(origins: List[np.ndarray], voxel_size: float,
                   n_scales: int) -> np.ndarray:
    """The elementwise lowest fragment origin, floored to the coarsest
    window grid: the scene anchor of the port's `window_union` mode."""
    snap = voxel_size * 2 ** n_scales
    lo = np.min(np.stack(origins), axis=0)
    return (np.floor(lo / snap + 1e-4) * snap).astype(np.float32)
