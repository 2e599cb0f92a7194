"""ARKit live-capture ingestion -> ScanNet-compatible fragments (own copy
of eprecon_tpu/tools/process_arkit_data.py).

Reference: tools/process_arkit_data.py:11-95 + tools/sync_poses.py:5-48 +
tools/kp_reproject.py:7-156 — extract frames from the capture video, sync
intrinsics/ARposes by timestamp, apply the ARKit→ScanNet axis fix, select
keyframes (15 deg / 0.1 m rule), shift z by +1.5 m, and write fragments.pkl
consumable by the streaming reconstructor. Decoding the capture video
needs cv2 (the one import of it in the port, local to extract_frames); a
capture whose frames are already images/N.jpg needs nothing beyond numpy.

CLI:
  python -m eprecon_tpu_torch.tools.process_arkit_data --data_path DIR \\
      [--n_views 9]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Tuple

import numpy as np


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def arkit_pose_to_scannet(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """ARKit camera pose -> ScanNet camera-to-world (reference
    kp_reproject.py ARKit axis fix: flip y/z camera axes)."""
    pose = np.eye(4)
    pose[:3, :3] = quat_to_mat(q)
    pose[:3, 3] = t
    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # ARKit looks down -z
    return pose @ flip


def sync_by_timestamp(frame_ts: np.ndarray, pose_ts: np.ndarray) -> np.ndarray:
    """Nearest-timestamp pose index per frame (reference sync_poses.py:5-48)."""
    idx = np.searchsorted(pose_ts, frame_ts)
    idx = np.clip(idx, 1, len(pose_ts) - 1)
    left = np.abs(pose_ts[idx - 1] - frame_ts)
    right = np.abs(pose_ts[idx] - frame_ts)
    return np.where(left < right, idx - 1, idx)


def load_arkit_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """ARposes.txt: 'ts, tx, ty, tz, qw, qx, qy, qz' per line."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            parts = [float(v) for v in line.replace(",", " ").split()]
            if len(parts) < 8:
                continue
            ts.append(parts[0])
            poses.append(arkit_pose_to_scannet(np.array(parts[1:4]),
                                               np.array(parts[4:8])))
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def load_intrinsics(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Frame.txt: 'ts, frame, fx, fy, cx, cy' per line."""
    ts, ks = [], []
    with open(path) as f:
        for line in f:
            parts = [float(v) for v in line.replace(",", " ").split()]
            if len(parts) < 6:
                continue
            ts.append(parts[0])
            fx, fy, cx, cy = parts[2:6]
            ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
    return np.asarray(ts), np.stack(ks) if ks else np.zeros((0, 3, 3))


def extract_frames(video_path: str, out_dir: str, size=(640, 480)) -> int:
    """Video -> numbered jpgs (reference kp_reproject.py:147-156)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "decoding the capture video needs OpenCV (cv2), which is not "
            "installed; install it, or extract the frames to "
            "<data_path>/images/N.jpg and remove Frames.m4v") from e

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.resize(frame, size)
        cv2.imwrite(os.path.join(out_dir, f"{i}.jpg"), frame)
        i += 1
    cap.release()
    return i


def process_data(data_path: str, n_views: int = 9,
                 z_offset: float = 1.5) -> List[dict]:
    """Assemble fragments.pkl from an ARKit capture directory
    (reference process_arkit_data.py:11-95)."""
    from eprecon_tpu_torch.tools.keyframes import build_fragments, select_keyframes

    video = os.path.join(data_path, "Frames.m4v")
    if os.path.exists(video):
        n_frames = extract_frames(video, os.path.join(data_path, "images"))
    else:
        img_dir = os.path.join(data_path, "images")
        n_frames = len([f for f in os.listdir(img_dir) if f.endswith(".jpg")])

    k_ts, ks = load_intrinsics(os.path.join(data_path, "Frames.txt"))
    p_ts, poses = load_arkit_poses(os.path.join(data_path, "ARposes.txt"))
    frame_ts = k_ts[:n_frames]
    pose_idx = sync_by_timestamp(frame_ts, p_ts)
    poses = poses[pose_idx]
    poses[:, 2, 3] += z_offset  # ScanNet z alignment (reference :83)

    kf = select_keyframes(list(poses))
    origin = poses[kf, :3, 3].min(axis=0) - 1.5 if kf else np.zeros(3)
    frags = build_fragments("arkit_capture", kf, origin, n_views)
    for fr in frags:
        fr["poses"] = poses[fr["image_ids"]]
        fr["intrinsics"] = ks[np.clip(fr["image_ids"], 0, len(ks) - 1)]
    with open(os.path.join(data_path, "fragments.pkl"), "wb") as f:
        pickle.dump(frags, f)
    return frags


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--n_views", type=int, default=9)
    args = ap.parse_args(argv)
    frags = process_data(args.data_path, args.n_views)
    print(f"{len(frags)} fragments")


if __name__ == "__main__":
    main()
