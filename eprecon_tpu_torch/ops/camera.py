"""Camera / projection math (port of eprecon_tpu/ops/camera.py; reference:
datasets/transforms.py:41-80, 443-459): on the host in numpy for building
fragment inputs, and `project_voxels` in PyTorch on the points' device."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def scale_intrinsics(intrinsics: np.ndarray, factor: float) -> np.ndarray:
    """Divide the first two rows of K by `factor` (reference
    transforms.py:71-72)."""
    intrinsics = np.asarray(intrinsics)
    k = intrinsics.astype(np.promote_types(intrinsics.dtype, np.float32))
    k[..., :2, :] /= factor
    return k


def projection_matrices(intrinsics: np.ndarray, extrinsics: np.ndarray,
                        stride: int = 4, n_scales: int = 3) -> np.ndarray:
    """Per-view per-scale 4x4 world->pixel matrices, [V, n_scales, 4, 4].

    intrinsics: [V, 3, 3]; extrinsics: [V, 4, 4] camera-to-world. Scale s
    uses K with its first two rows divided by stride * 2**s.
    """
    world2cam = np.linalg.inv(extrinsics)
    mats = []
    for s in range(n_scales):
        k = scale_intrinsics(np.asarray(intrinsics, np.float64),
                             stride * 2 ** s)
        proj = world2cam.copy()
        proj[:, :3, :4] = np.einsum("vij,vjk->vik", k, world2cam[:, :3, :4])
        mats.append(proj)
    return np.stack(mats, axis=1).astype(np.float32)


def _axangle_to_mat(axis: np.ndarray, theta: float) -> np.ndarray:
    x, y, z = axis
    c, s = np.cos(theta), np.sin(theta)
    C = 1.0 - c
    return np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ])


def rotate_view_to_align_xyplane(cam_to_world: np.ndarray) -> np.ndarray:
    """3x3 rotation taking the camera-space world-up vector onto
    camera-space [0, -1, 0], by axis and angle (reference:
    datasets/transforms.py:48-56)."""
    world2cam = np.linalg.inv(cam_to_world)
    z_c = (world2cam @ np.array([0.0, 0.0, 1.0, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0.0, -1.0, 0.0]))
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    theta = np.arccos(np.clip(-z_c[1] / (np.linalg.norm(z_c) + 1e-12),
                              -1.0, 1.0))
    return _axangle_to_mat(axis, theta)


def world_to_aligned_camera(middle_pose: np.ndarray) -> np.ndarray:
    """4x4 transform from world to the gravity-aligned middle-camera frame
    (reference: datasets/transforms.py:48-63)."""
    rot4 = np.eye(4)
    rot4[:3, :3] = rotate_view_to_align_xyplane(middle_pose)
    return (rot4 @ np.linalg.inv(middle_pose)).astype(np.float32)


def view_frustum_points(max_depth: float, im_hw: Tuple[int, int],
                        cam_intr: np.ndarray, cam_pose: np.ndarray
                        ) -> np.ndarray:
    """Corners of the camera's view frustum in world space, [3, 5]: the
    centre, then the image corners at `max_depth` (reference:
    datasets/transforms.py:443-459)."""
    im_h, im_w = im_hw
    d = np.array([0, max_depth, max_depth, max_depth, max_depth])
    xs = (np.array([0, 0, 0, im_w, im_w]) - cam_intr[0, 2]) * d / cam_intr[0, 0]
    ys = (np.array([0, 0, im_h, 0, im_h]) - cam_intr[1, 2]) * d / cam_intr[1, 1]
    pts = np.stack([xs, ys, d])
    pts_h = np.concatenate([pts, np.ones((1, 5))])
    return (cam_pose @ pts_h)[:3]


def project_voxels(world_xyz: torch.Tensor, proj: torch.Tensor,
                   im_hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project world points [N, 3] into V views, proj [V, 4, 4]
    world->pixel at one scale, images of im_hw = (height, width).
    Returns (uv [V, N, 2], depth [V, N], mask [V, N]: in the image and in
    front of the camera; reference models/occupancy_initialization.py:
    87-102, |2u/(w-1) - 1| <= 1 as 0 <= u <= w-1)."""
    h, w = im_hw
    pts = torch.cat([world_xyz, torch.ones_like(world_xyz[:, :1])], dim=1)
    cam = torch.einsum("vij,nj->vni", proj, pts)
    z = cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam[..., 0] / safe_z
    v = cam[..., 1] / safe_z
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 0)
    return torch.stack([u, v], dim=-1), z, inb
