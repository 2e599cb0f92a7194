"""Export per-scene labeled point clouds from ScanNet annotation files
(own copy of eprecon_tpu/tools/load_scannet_labels.py).

Reference: datasets/scannet/load_scannet_data.py:66-138 +
batch_load_scannet_data.py:33-50 + scannet_utils.py — reads the GT mesh
(_vh_clean_2.ply), over-segmentation json, and aggregation json, producing
(points xyz+rgb, per-point nyu40 semantic ids, per-point instance ids) with
the reference's id convention: wall=1 / floor=2 fixed, things from 3.
The files it writes ({scene}_vert.npy, _sem_label.npy, _ins_label.npy) are
what tools/generate_gt.load_label_points reads.

CLI:
  python -m eprecon_tpu_torch.tools.load_scannet_labels \\
      --scannet_path <root>/scans --label_map_file scannetv2-labels.combined.tsv \\
      --output_folder <root>/labels
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, Tuple

import numpy as np


def read_label_mapping(tsv_path: str, label_from: str = "raw_category",
                       label_to: str = "nyu40id") -> Dict[str, int]:
    """scannetv2-labels.combined.tsv: raw category -> nyu40 id
    (reference scannet_utils.py)."""
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def export(scene_dir: str, scene: str, label_map: Dict[str, int]
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (verts [N, 6] xyzrgb, semantic [N] nyu40, instance [N])."""
    from eprecon_tpu_torch.tools.ply_io import read_ply_vertices

    mesh = os.path.join(scene_dir, f"{scene}_vh_clean_2.ply")
    verts = read_ply_vertices(mesh)
    segs_file = os.path.join(scene_dir, f"{scene}_vh_clean_2.0.010000.segs.json")
    agg_file = os.path.join(scene_dir, f"{scene}.aggregation.json")
    with open(segs_file) as f:
        seg_to_verts = np.asarray(json.load(f)["segIndices"])
    with open(agg_file) as f:
        agg = json.load(f)

    n = len(verts)
    semantic = np.zeros(n, np.int32)
    instance = np.zeros(n, np.int32)
    # reference id convention (batch_load_scannet_data.py:33-50):
    # wall -> instance 1, floor -> instance 2, things from 3
    next_thing = 3
    for group in agg["segGroups"]:
        cls = label_map.get(group["label"], 0)
        mask = np.isin(seg_to_verts, group["segments"])
        semantic[mask] = cls
        if cls == 1:
            instance[mask] = 1
        elif cls == 2:
            instance[mask] = 2
        else:
            instance[mask] = next_thing
            next_thing += 1
    rgb = np.zeros((n, 3), np.float32)
    return np.concatenate([verts, rgb], axis=1), semantic, instance


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scannet_path", required=True)
    ap.add_argument("--label_map_file", required=True)
    ap.add_argument("--output_folder", required=True)
    args = ap.parse_args(argv)
    label_map = read_label_mapping(args.label_map_file)
    os.makedirs(args.output_folder, exist_ok=True)
    for scene in sorted(os.listdir(args.scannet_path)):
        sdir = os.path.join(args.scannet_path, scene)
        if not os.path.isdir(sdir):
            continue
        verts, sem, ins = export(sdir, scene, label_map)
        np.save(os.path.join(args.output_folder, f"{scene}_vert.npy"), verts)
        np.save(os.path.join(args.output_folder, f"{scene}_sem_label.npy"), sem)
        np.save(os.path.join(args.output_folder, f"{scene}_ins_label.npy"), ins)
        print(scene, len(verts))


if __name__ == "__main__":
    main()
