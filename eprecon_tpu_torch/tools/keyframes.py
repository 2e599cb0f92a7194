"""Keyframe selection and fragment assembly (own copy of
eprecon_tpu/tools/keyframes.py).

Reference: tools/tsdf_fusion/generate_gt.py:243-307 (save_fragment_pkl) and
tools/process_arkit_data.py:54-76 — a frame becomes a keyframe when the
camera moved > tmax meters or rotated > rmax degrees since the last
keyframe; keyframes are grouped into fixed-size fragments.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def is_valid_pose(pose: np.ndarray) -> bool:
    return bool(np.isfinite(pose).all())


def select_keyframes(poses: Sequence[np.ndarray], rmax_deg: float = 15.0,
                     tmax: float = 0.1) -> List[int]:
    """Indices of keyframes under the angle/translation rule."""
    ids = []
    last_pose = None
    for i, pose in enumerate(poses):
        if not is_valid_pose(pose):
            continue
        if last_pose is None:
            ids.append(i)
            last_pose = pose
            continue
        angle = np.arccos(np.clip(
            (np.trace(pose[:3, :3] @ last_pose[:3, :3].T) - 1) / 2, -1, 1))
        dist = np.linalg.norm(pose[:3, 3] - last_pose[:3, 3])
        if np.degrees(angle) > rmax_deg or dist > tmax:
            ids.append(i)
            last_pose = pose
    return ids


def build_fragments(scene: str, keyframe_ids: List[int], vol_origin,
                    n_views: int = 9) -> List[Dict]:
    """Group keyframes into n_views-sized fragments
    (reference generate_gt.py:291-307)."""
    return [dict(scene=scene, fragment_id=f,
                 image_ids=keyframe_ids[f * n_views:(f + 1) * n_views],
                 vol_origin=np.asarray(vol_origin, np.float32))
            for f in range(len(keyframe_ids) // n_views)]
