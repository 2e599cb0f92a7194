"""Write synthetic scenes to disk in the ScanNet on-disk layout (port of
eprecon_tpu/tools/make_synthetic_scannet.py).

Produces everything the real-data path consumes — per-scene color jpgs,
depth pngs (uint16 millimeters), pose txts, intrinsic txts (the layout of
the reference's datasets/scannet/reader.py exports), plus the label export
files ({scene}_vert.npy / _sem_label.npy / _ins_label.npy, the format of
reference datasets/scannet/load_scannet_data.py:66-138) — so that
generate_gt -> ScanNetDataset -> train/test runs end to end without a
download. Images go through the port's native writers
(data/native_loader.py): color as cv2.imwrite writes it (BGR, JPEG quality
95, 4:2:0), depth as a 16-bit PNG.

CLI:
  python -m eprecon_tpu_torch.tools.make_synthetic_scannet --out DIR \\
      [--scenes 2] [--frames 40] [--color_height 968 --color_width 1296]
"""
from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from eprecon_tpu_torch.data.native_loader import write_jpeg, write_png16
from eprecon_tpu_torch.data.synthetic import (make_scene, orbit_poses,
                                              render_view, walkthrough_poses)


def _backproject_labeled_points(depth, intr, pose, sem, ins, stride=4):
    """Labeled world points from a rendered view (stand-in for the ScanNet
    mesh-vertex label export)."""
    h, w = depth.shape
    ys, xs = np.meshgrid(np.arange(0, h, stride), np.arange(0, w, stride),
                         indexing="ij")
    d = depth[ys, xs]
    ok = d > 0
    x = (xs[ok] - intr[0, 2]) * d[ok] / intr[0, 0]
    y = (ys[ok] - intr[1, 2]) * d[ok] / intr[1, 1]
    pts_c = np.stack([x, y, d[ok]], axis=1)
    pts_w = pts_c @ pose[:3, :3].T + pose[:3, 3]
    return pts_w, sem[ys, xs][ok], ins[ys, xs][ok]


def _color_intrinsics(depth_intr: np.ndarray, depth_hw: Tuple[int, int],
                      color_hw: Tuple[int, int]) -> np.ndarray:
    """Color intrinsics consistent with real ScanNet's 1296x968 vs 640x480
    split: x scales by w_c/w_d; y is laid out so that the loader's
    pad_scannet step (cy += 2 then treat h as 972, reference
    datasets/transforms.py:83-116) makes the padded color intrinsics exactly
    proportional to the depth intrinsics."""
    dh, dw = depth_hw
    ch, cw = color_hw
    sx = cw / dw
    pad = 4 if (ch, cw) == (968, 1296) else 0  # 968 -> 972 vertical pad
    sy = (ch + pad) / dh
    intr = depth_intr.copy()
    intr[0, :] *= sx
    intr[1, :] *= sy
    intr[1, 2] -= pad / 2
    return intr


def write_scene(scans_dir: str, labels_dir: str, scene: str, seed: int = 0,
                n_frames: int = 40, image_hw: Tuple[int, int] = (480, 640),
                color_hw: Optional[Tuple[int, int]] = None, n_rooms: int = 1):
    """image_hw is the DEPTH resolution (and color's, when color_hw is None).
    color_hw=(968, 1296) reproduces real ScanNet's split color/depth
    resolutions including the 968->972 pad relationship; n_rooms > 1 writes
    a walkthrough of doorway-connected rooms spanning several fragment
    windows. Frames are rendered and written on a thread pool (numpy and
    the codecs release the GIL)."""
    root = os.path.join(scans_dir, scene)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)

    sc = make_scene(seed, n_rooms=n_rooms, textured=True)
    h, w = image_hw
    f = 0.9 * w / 2
    intr = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)
    color_intr = (intr if color_hw is None
                  else _color_intrinsics(intr, image_hw, color_hw))
    for name, k in (("intrinsic_color.txt", color_intr),
                    ("intrinsic_depth.txt", intr)):
        intr4 = np.eye(4, dtype=np.float32)
        intr4[:3, :3] = k
        np.savetxt(os.path.join(root, "intrinsic", name), intr4)

    if n_rooms > 1:
        poses = walkthrough_poses(n_frames, n_rooms)
    else:
        poses = orbit_poses(n_frames, start=0.0,
                            sweep=2 * np.pi * (n_frames - 1) / n_frames)

    def frame(i):
        depth, rgb, sem, ins = render_view(sc, intr, poses[i], image_hw)
        if color_hw is not None:
            _, rgb, _, _ = render_view(sc, color_intr, poses[i], color_hw)
        write_jpeg(os.path.join(root, "color", f"{i}.jpg"), rgb.astype(np.uint8))
        write_png16(os.path.join(root, "depth", f"{i}.png"),
                    (depth * 1000.0).astype(np.uint16))
        np.savetxt(os.path.join(root, "pose", f"{i}.txt"), poses[i])
        if i % 4 == 0:
            return _backproject_labeled_points(depth, intr, poses[i], sem, ins)
        return None

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        labeled = [x for x in ex.map(frame, range(n_frames)) if x is not None]
    pts = np.concatenate([x[0] for x in labeled]).astype(np.float32)
    verts = np.concatenate([pts, np.zeros_like(pts)], axis=1)  # xyzrgb
    np.save(os.path.join(labels_dir, f"{scene}_vert.npy"), verts)
    np.save(os.path.join(labels_dir, f"{scene}_sem_label.npy"),
            np.concatenate([x[1] for x in labeled]).astype(np.int32))
    np.save(os.path.join(labels_dir, f"{scene}_ins_label.npy"),
            np.concatenate([x[2] for x in labeled]).astype(np.int32))
    return root


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="dataset root; scenes go under <out>/scans")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--color_height", type=int, default=0,
                    help="968 + --color_width 1296 = real ScanNet split")
    ap.add_argument("--color_width", type=int, default=0)
    ap.add_argument("--rooms", type=int, default=1)
    args = ap.parse_args(argv)

    scans = os.path.join(args.out, "scans")
    labels = os.path.join(args.out, "labels")
    color_hw = ((args.color_height, args.color_width)
                if args.color_height and args.color_width else None)
    for s in range(args.scenes):
        scene = f"scene{s:04d}_00"
        write_scene(scans, labels, scene, seed=s, n_frames=args.frames,
                    image_hw=(args.height, args.width), color_hw=color_hw,
                    n_rooms=args.rooms)
        print(f"{scene}: wrote {args.frames} frames")


if __name__ == "__main__":
    main()
