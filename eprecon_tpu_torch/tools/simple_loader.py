"""Per-frame ScanNet scene loader for GT generation (own copy of
eprecon_tpu/tools/simple_loader.py).

Reference: tools/simple_loader.py:13-55 — loads depth, pose and intrinsics
per frame from an extracted ScanNet scene directory. Depth is decoded by
the port's native library (data/native_loader.py).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from eprecon_tpu_torch.data.native_loader import decode_png_depth
from eprecon_tpu_torch.tools.keyframes import is_valid_pose


class ScanNetSceneLoader:
    def __init__(self, data_path: str, scene: str, max_depth: float = 3.0):
        self.root = os.path.join(data_path, scene)
        self.scene = scene
        self.max_depth = max_depth
        depth_dir = os.path.join(self.root, "depth")
        self.frame_ids = sorted(
            int(f.split(".")[0]) for f in os.listdir(depth_dir)
            if f.endswith(".png"))

    def __len__(self):
        return len(self.frame_ids)

    def intrinsics(self) -> np.ndarray:
        return np.loadtxt(os.path.join(
            self.root, "intrinsic", "intrinsic_depth.txt"))[:3, :3].astype(np.float32)

    def frame(self, fid: int) -> Dict[str, np.ndarray]:
        depth = decode_png_depth(os.path.join(self.root, "depth", f"{fid}.png"),
                                 self.max_depth)
        pose = np.loadtxt(os.path.join(self.root, "pose", f"{fid}.txt")).astype(np.float32)
        return dict(depth=depth, pose=pose)

    def load_all(self) -> Dict[str, List[np.ndarray]]:
        k = self.intrinsics()
        depths, poses, intrinsics, kept = [], [], [], []
        for fid in self.frame_ids:
            fr = self.frame(fid)
            if not is_valid_pose(fr["pose"]):
                continue  # bad-pose frames skipped (reference generate_gt.py:334)
            depths.append(fr["depth"])
            poses.append(fr["pose"])
            intrinsics.append(k)
            kept.append(fid)
        # frame_ids are the kept files' ids, aligned with depths/poses, so
        # keyframe indices map back to the on-disk color/<id>.jpg names
        return dict(depths=depths, poses=poses, intrinsics=intrinsics,
                    frame_ids=kept)
