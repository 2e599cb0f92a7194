"""Export predicted scenes to ScanNet benchmark submission format (own copy
of eprecon_tpu/tools/generate_semantic_instance.py).

Reference: tools/generate_semantic_instance.py:12-95 — maps the 20 internal
class ids back to nyu40 ids, transfers per-voxel labels to the GT mesh
vertices by nearest neighbor, writes the semantic txt + per-instance mask
files the ScanNet evaluator expects.

CLI:
  python -m eprecon_tpu_torch.tools.generate_semantic_instance \\
      --scene_npz <logdir>/scenes/<scene>.npz \\
      --gt_mesh <scene>_vh_clean_2.ply --out <dir>
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

# 20-class id -> nyu40 id (reference :32; inverse of criterion.VALID_CLASSES)
ID20_TO_NYU40 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16,
                          24, 28, 33, 34, 36, 39], np.int32)


def transfer_labels_to_vertices(verts: np.ndarray, origin: np.ndarray,
                                voxel_size: float, semantic: np.ndarray,
                                instance: np.ndarray):
    """Nearest-voxel label transfer (reference :42-52 KDTree over voxel
    centers: on a voxel grid direct rounding is exact and O(1)); unlabeled
    vertices take the labels of the nearest labeled vertex."""
    idx = np.round((verts - origin) / voxel_size).astype(int)
    idx = np.clip(idx, 0, np.array(semantic.shape) - 1)
    sem = semantic[idx[:, 0], idx[:, 1], idx[:, 2]]
    ins = instance[idx[:, 0], idx[:, 1], idx[:, 2]]
    # fill unlabeled vertices from the nearest labeled voxel
    unl = sem == 0
    if unl.any() and (~unl).any():
        from scipy.spatial import cKDTree

        tree = cKDTree(verts[~unl])
        _, nn = tree.query(verts[unl], k=1)
        sem[unl] = sem[~unl][nn]
        ins[unl] = ins[~unl][nn]
    return sem, ins


def export_scene(scene_npz: str, gt_mesh_verts: np.ndarray, out_dir: str,
                 scene_name: Optional[str] = None):
    """Write <scene>.txt (semantic nyu40 per vertex) + instance masks
    (reference :54-80) under out_dir/semantic and out_dir/instance."""
    data = np.load(scene_npz, allow_pickle=True)
    name = scene_name or os.path.splitext(os.path.basename(scene_npz))[0]
    sem20, ins = transfer_labels_to_vertices(
        gt_mesh_verts, data["origin"], float(data["voxel_size"]),
        data["semantic"], data["instance"])
    sem40 = ID20_TO_NYU40[np.clip(sem20, 0, 20)]

    os.makedirs(os.path.join(out_dir, "semantic"), exist_ok=True)
    np.savetxt(os.path.join(out_dir, "semantic", f"{name}.txt"), sem40, "%d")

    mask_dir = os.path.join(out_dir, "instance", "predicted_masks")
    os.makedirs(mask_dir, exist_ok=True)
    lines = []
    for k, iid in enumerate(np.unique(ins)):
        if iid == 0:
            continue
        mask = (ins == iid).astype(np.int32)
        cls20 = np.bincount(sem20[mask > 0], minlength=21).argmax()
        cls40 = int(ID20_TO_NYU40[cls20])
        rel = f"predicted_masks/{name}_{k:03d}.txt"
        np.savetxt(os.path.join(mask_dir, f"{name}_{k:03d}.txt"), mask, "%d")
        lines.append(f"{rel} {cls40} 1.0")
    with open(os.path.join(out_dir, "instance", f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene_npz", required=True)
    ap.add_argument("--gt_mesh", required=True, help="GT .ply for vertices")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from eprecon_tpu_torch.tools.ply_io import read_ply_vertices

    verts = read_ply_vertices(args.gt_mesh)
    export_scene(args.scene_npz, verts, args.out)


if __name__ == "__main__":
    main()
