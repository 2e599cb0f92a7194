"""Camera / projection math on the host (numpy), for building fragment
inputs. Port of the functions of eprecon_tpu/ops/camera.py that the
synthetic data needs (reference: datasets/transforms.py:41-80)."""
from __future__ import annotations

import numpy as np


def projection_matrices(intrinsics: np.ndarray, extrinsics: np.ndarray,
                        stride: int = 4, n_scales: int = 3) -> np.ndarray:
    """Per-view per-scale 4x4 world->pixel matrices, [V, n_scales, 4, 4].

    intrinsics: [V, 3, 3]; extrinsics: [V, 4, 4] camera-to-world. Scale s
    uses K with its first two rows divided by stride * 2**s.
    """
    world2cam = np.linalg.inv(extrinsics)
    mats = []
    for s in range(n_scales):
        k = np.array(intrinsics, np.float64)
        k[:, :2, :] = k[:, :2, :] / (stride * 2 ** s)
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


def world_to_aligned_camera(middle_pose: np.ndarray) -> np.ndarray:
    """4x4 transform from world to the gravity-aligned middle-camera frame
    (reference: datasets/transforms.py:48-63): rotate the camera-space
    world-up vector onto camera-space [0, -1, 0]."""
    world2cam = np.linalg.inv(middle_pose)
    z_c = (world2cam @ np.array([0.0, 0.0, 1.0, 0.0]))[:3]
    axis = np.cross(z_c, np.array([0.0, -1.0, 0.0]))
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    theta = np.arccos(np.clip(-z_c[1] / (np.linalg.norm(z_c) + 1e-12),
                              -1.0, 1.0))
    rot4 = np.eye(4)
    rot4[:3, :3] = _axangle_to_mat(axis, theta)
    return (rot4 @ world2cam).astype(np.float32)
