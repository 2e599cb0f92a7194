"""Scene-level 3D evaluation (port of eprecon_tpu/tools/evaluation.py).

Reference: tools/evaluation.py:45-158 — per test frame, render the
predicted mesh to depth (pyrender), compute 2D depth metrics, re-fuse the
rendered depth (open3d ScalableTSDFVolume) to trim unobserved-region fill,
then compare point clouds (eval_mesh). As in the JAX package, depth is
rendered by ray-marching the predicted TSDF volume (plain PyTorch, on the
volume's device: CUDA unless the caller passes the CPU), the trim
re-fusion is ops/tsdf_fusion, and the point metrics come from
tools/evaluation_utils. The closed-loop score (`evaluate_scene_vs_gt`)
compares a finished scene's mesh with the GT volume's mesh (F-score) and
its labels, transferred onto the GT voxels, with the GT labels (PQ).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from eprecon_tpu_torch.device import DeviceLike, resolve_device

def render_tsdf_depth(tsdf: torch.Tensor, origin, voxel_size: float, intr,
                      cam_pose, hw=(480, 640), max_depth: float = 6.0,
                      n_steps: int = 192) -> torch.Tensor:
    """Ray-march a dense TSDF volume [X, Y, Z] to a depth map [H, W] on the
    volume's device: `n_steps` fixed steps to `max_depth`, trilinear
    samples (outside the volume +1), the first + to - crossing refined
    linearly; 0 where no ray crosses. The JAX function's arithmetic, step
    by step."""
    dev = tsdf.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    origin, intr, cam_pose = f32(origin), f32(intr), f32(cam_pose)
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs_cam = torch.stack([(xs - intr[0, 2]) / intr[0, 0],
                            (ys - intr[1, 2]) / intr[1, 1],
                            torch.ones_like(xs)], -1).reshape(-1, 3)
    dirs = dirs_cam @ cam_pose[:3, :3].T
    o = cam_pose[:3, 3]
    dim = torch.tensor(tsdf.shape, device=dev)
    strides = torch.tensor([tsdf.shape[1] * tsdf.shape[2], tsdf.shape[2], 1],
                           device=dev)
    flat = tsdf.reshape(-1).float()

    def sample(pts):
        g = (pts - origin) / voxel_size
        g0 = torch.floor(g)
        f = (g - g0).T                                    # [3, N]
        lo = g0.long().T
        # per axis, both corners' in-volume masks, clamped offsets and
        # weights: [3, 2, N] (rays last, so each op runs over rays)
        c = torch.stack([lo, lo + 1], 1)
        inb = (c >= 0) & (c < dim[:, None, None])
        off = (torch.minimum(c.clamp(min=0), (dim - 1)[:, None, None])
               * strides[:, None, None])
        wgt = torch.stack([1 - f, f], 1)
        # [cz, cy, cx, N] -> [8, N], cx fastest: the JAX loop's order
        corner = lambda t, op: op(op(t[2, :, None, None], t[1, None, :, None]),
                                  t[0, None, None, :]).reshape(8, -1)
        v = torch.where(corner(inb, torch.logical_and),
                        flat[corner(off, torch.add)], 1.0)
        w = ((wgt[0, None, None, :] * wgt[1, None, :, None])
             * wgt[2, :, None, None]).reshape(8, -1)
        val = torch.zeros(pts.shape[0], device=dev)
        for k in range(8):
            val = val + v[k] * w[k]
        return val

    step = np.float32(max_depth / n_steps)
    t_hit = torch.full((dirs.shape[0],), -1.0, device=dev)
    prev = sample(o[None, :] + dirs * 1e-4)
    for i in range(n_steps):
        t = np.float32(i + 1) * step
        v = sample(o[None, :] + dirs * float(t))
        crossed = (prev > 0) & (v <= 0) & (t_hit < 0)
        diff = prev - v
        denom = torch.where(diff.abs() < 1e-9, torch.full_like(diff, 1e-9), diff)
        t_cross = float(t - step) + float(step) * prev / denom
        t_hit = torch.where(crossed, t_cross, t_hit)
        prev = v
    z = torch.where(t_hit > 0, t_hit * dirs_cam[:, 2], torch.zeros_like(t_hit))
    return z.reshape(h, w)


def trim_tsdf(depths, intrinsics, poses, origin, dim, voxel_size: float = 0.06,
              device: DeviceLike = None):
    """Re-fuse rendered depths to trim hole fill in unobserved regions
    (reference evaluation.py:103-147 open3d re-fusion), on `device`.
    Returns (tsdf, weight) as numpy."""
    from eprecon_tpu_torch.ops import tsdf_fusion

    device = resolve_device(device)
    on_dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    t, w = tsdf_fusion.fuse_frames(
        on_dev(np.stack(depths)), on_dev(np.stack(intrinsics)),
        on_dev(np.stack(poses)), on_dev(origin), dim, voxel_size)
    return t.cpu().numpy(), w.cpu().numpy()


def evaluate_scene(pred_npz: str, gt_mesh_verts: np.ndarray,
                   test_frames: Optional[dict] = None,
                   max_frames: int = 200, trim_voxel: float = 0.04,
                   device: DeviceLike = None) -> Dict[str, float]:
    """Full per-scene protocol (reference evaluation.py:85-158): render the
    predicted TSDF at every held-out frame on `device` -> 2D depth metrics
    -> re-fuse the rendered depth at `trim_voxel` (reference
    voxel_length=0.04, :103) to trim hole fill -> mesh metrics on the
    trimmed surface. The trim voxel is at least the prediction's own voxel
    size."""
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes
    from eprecon_tpu_torch.tools.evaluation_utils import eval_depth, eval_mesh

    data = np.load(pred_npz, allow_pickle=True)
    tsdf = data["tsdf"]
    origin = data["origin"]
    vsz = float(data["voxel_size"])

    metrics: Dict[str, float] = {}
    if test_frames is not None:
        device = resolve_device(device)
        tsdf_d = torch.from_numpy(np.asarray(tsdf, np.float32)).to(device)
        depth_metrics, rendered, used_k, used_p = [], [], [], []
        sel = np.linspace(0, len(test_frames["depths"]) - 1,
                          min(max_frames, len(test_frames["depths"]))).astype(int)
        for i in sel:
            d_gt = test_frames["depths"][i]
            k = test_frames["intrinsics"][i]
            p = test_frames["poses"][i]
            d_pred = render_tsdf_depth(tsdf_d, origin, vsz, k, p,
                                       hw=d_gt.shape).cpu().numpy()
            depth_metrics.append(eval_depth(d_pred, d_gt))
            rendered.append(d_pred)
            used_k.append(k)
            used_p.append(p)
        for key in depth_metrics[0]:
            metrics[key] = float(np.nanmean([m[key] for m in depth_metrics]))
        # trim: re-fuse rendered depth, evaluate the trimmed surface
        tv = max(trim_voxel, vsz)
        dim = tuple(int(np.ceil(s * vsz / tv)) + 1 for s in tsdf.shape)
        t_trim, _ = trim_tsdf(rendered, used_k, used_p, origin, dim, tv, device)
        if (np.abs(t_trim) < 1).any():
            verts, _, _ = marching_cubes(t_trim)
            verts_pred = verts * tv + origin[None, :]
        else:
            verts_pred = np.zeros((0, 3))
    else:
        verts, _, _ = marching_cubes(tsdf)
        verts_pred = verts * vsz + origin[None, :]

    metrics.update(eval_mesh(verts_pred, gt_mesh_verts))
    return metrics


def evaluate_scene_vs_gt(result, gt_dir: str,
                         stuff_ids=(1, 2)) -> Dict[str, float]:
    """Closed-loop scene metrics against generated GT volumes: mesh F-score
    (eval_mesh protocol, reference tools/evaluation_utils.py:5-42) + native
    voxel PQ/SQ/RQ.

    result: inference.pipeline.SceneResult; gt_dir: the all_tsdf_9 directory
    holding <scene>/full_tsdf_layer0.npz (+ label volumes). GT and prediction
    share the scene world frame (fragment metas carry the GT vol_origin), so
    volumes are aligned by integer offset.
    """
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes
    from eprecon_tpu_torch.tools.evaluation_utils import eval_mesh, panoptic_quality

    root = os.path.join(gt_dir, result.name)
    gt_tsdf = np.load(os.path.join(root, "full_tsdf_layer0.npz"),
                      allow_pickle=True)["arr_0"]
    info = os.path.join(root, "tsdf_info.npz")
    if os.path.exists(info):
        gt_origin = np.load(info)["vol_origin"].astype(np.float32)
    else:
        gt_origin = None

    metrics: Dict[str, float] = {}
    vsz = float(result.voxel_size)
    if (np.abs(result.tsdf) < 1).any() and (np.abs(gt_tsdf) < 1).any():
        vp, _, _ = marching_cubes(result.tsdf)
        verts_pred = vp * vsz + result.origin[None, :]
        vg, _, _ = marching_cubes(gt_tsdf)
        if gt_origin is None:
            # without a recorded origin both meshes can only be compared in
            # the pred frame; assume GT shares the scene origin of the pred
            gt_origin = result.origin
        verts_gt = vg * vsz + gt_origin[None, :]
        metrics.update(eval_mesh(verts_pred, verts_gt))

    sem_p = os.path.join(root, "full_semantic_layer_interpolate0.npz")
    ins_p = os.path.join(root, "full_instance_layer_interpolate0.npz")
    if os.path.exists(sem_p) and os.path.exists(ins_p) and gt_origin is not None:
        from eprecon_tpu_torch.tools.evaluation_utils import transfer_labels_to_gt

        gt_sem = np.load(sem_p, allow_pickle=True)["arr_0"]
        gt_ins = np.load(ins_p, allow_pickle=True)["arr_0"]
        gt_occ = np.abs(gt_tsdf) < 0.999
        # reference protocol: predicted labels are transferred onto the GT
        # geometry by nearest neighbour before PQ (the ScanNet benchmark's
        # treatment of the per-vertex export from
        # reference tools/generate_semantic_instance.py:54-80)
        sel3 = gt_occ & (gt_ins > 0)
        pred_sem, pred_ins = transfer_labels_to_gt(
            result.semantic, result.instance, result.origin, sel3,
            gt_origin, vsz)
        gt_sem_v = gt_sem[sel3]
        gt_ins_v = gt_ins[sel3]

        # per-segment class maps by majority vote
        def cls_map(seg, sem):
            out = {}
            for i in np.unique(seg):
                if i == 0:
                    continue
                vals = sem[seg == i]
                out[int(i)] = int(np.bincount(vals).argmax()) if len(vals) else 0
            return out
        metrics.update(panoptic_quality(
            pred_ins, cls_map(pred_ins, pred_sem),
            gt_ins_v, cls_map(gt_ins_v, gt_sem_v)))
    return metrics


def gt_scene_verts(gt_dir: str, scene: str) -> Optional[np.ndarray]:
    """World-frame GT surface vertices from the generated GT volumes
    (marching cubes over full_tsdf_layer0; the reference compares against
    <scene>_vh_clean_2.ply mesh vertices — same protocol, different source
    because GT here is the fused volume)."""
    from eprecon_tpu_torch.inference.mesh_export import marching_cubes

    root = os.path.join(gt_dir, scene)
    tsdf_p = os.path.join(root, "full_tsdf_layer0.npz")
    if not os.path.exists(tsdf_p):
        return None
    gt_tsdf = np.load(tsdf_p, allow_pickle=True)["arr_0"]
    if not (np.abs(gt_tsdf) < 1).any():
        return None
    info = os.path.join(root, "tsdf_info.npz")
    origin = (np.load(info)["vol_origin"].astype(np.float32)
              if os.path.exists(info) else np.zeros(3, np.float32))
    info_d = np.load(info) if os.path.exists(info) else {}
    vsz = float(info_d["voxel_size"]) if "voxel_size" in info_d else 0.04
    verts, _, _ = marching_cubes(gt_tsdf)
    return verts * vsz + origin[None, :]


def load_test_frames(data_path: str, scene: str,
                     max_frames: Optional[int] = None) -> Optional[dict]:
    """Held-out eval frames (depth maps + depth intrinsics + poses) from a
    ScanNet-layout scene directory (reference tools/evaluation.py:60-84
    reads them from the .sens stream; the prepared tree stores the same
    content as depth/<id>.png + intrinsic/intrinsic_depth.txt +
    pose/<id>.txt), depth decoded by the port's native library. Frames
    with non-finite poses are skipped (real ScanNet has them). Returns None
    when the scene directory is absent."""
    from eprecon_tpu_torch.data.native_loader import decode_png_depth

    root = None
    for sub in ("scans_test", "scans"):
        cand = os.path.join(data_path, sub, scene)
        if os.path.isdir(cand):
            root = cand
            break
    if root is None:
        return None
    ids = sorted(int(f[:-4]) for f in os.listdir(os.path.join(root, "depth"))
                 if f.endswith(".png"))
    if max_frames is not None and len(ids) > max_frames:
        ids = [ids[i] for i in
               np.linspace(0, len(ids) - 1, max_frames).astype(int)]
    intr_path = os.path.join(root, "intrinsic", "intrinsic_depth.txt")
    if not os.path.exists(intr_path):
        intr_path = os.path.join(root, "intrinsic", "intrinsic_color.txt")
    intr = np.loadtxt(intr_path).astype(np.float32)[:3, :3]
    frames = {"depths": [], "intrinsics": [], "poses": []}
    for i in ids:
        pose = np.loadtxt(os.path.join(root, "pose", f"{i}.txt")).astype(
            np.float32)
        if not np.isfinite(pose).all():
            continue
        frames["depths"].append(
            decode_png_depth(os.path.join(root, "depth", f"{i}.png")))
        frames["intrinsics"].append(intr)
        frames["poses"].append(pose)
    return frames if frames["depths"] else None


def main(argv=None):
    """Batch depth-protocol evaluation over saved scene volumes (reference
    tools/evaluation.py:161-208 __main__): for every <scene>.npz in
    --result_dir, render predicted depth at the held-out test frames,
    compute 2D depth metrics, trim-refuse, score the trimmed mesh against
    GT, merge into <scene>_metrics.json, and print the nanmean table.

      python -m eprecon_tpu_torch.tools.evaluation --result_dir out/scenes \\
          --data_path /data/scannet [--gt_dir .../all_tsdf_9] [--max_frames N] \\
          [--device cuda]
    """
    import argparse

    ap = argparse.ArgumentParser("eprecon (PyTorch) scene evaluation")
    ap.add_argument("--result_dir", required=True,
                    help="directory of <scene>.npz saved by run_test")
    ap.add_argument("--data_path", required=True,
                    help="ScanNet-layout root (scans[_test]/<scene>/...)")
    ap.add_argument("--gt_dir", default=None,
                    help="GT volume dir (default <data_path>/all_tsdf_9)")
    ap.add_argument("--max_frames", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device of the rendering and trimming "
                         "(default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gt_dir = args.gt_dir or os.path.join(args.data_path, "all_tsdf_9")

    scenes = sorted(f[:-4] for f in os.listdir(args.result_dir)
                    if f.endswith(".npz"))
    for scene in scenes:
        gt_verts = gt_scene_verts(gt_dir, scene)
        if gt_verts is None:
            print(f"{scene}: no GT volume under {gt_dir}, skipped")
            continue
        frames = load_test_frames(args.data_path, scene, args.max_frames)
        m = evaluate_scene(os.path.join(args.result_dir, f"{scene}.npz"),
                           gt_verts, frames, max_frames=args.max_frames,
                           device=device)
        mpath = os.path.join(args.result_dir, f"{scene}_metrics.json")
        merged = {}
        if os.path.exists(mpath):
            with open(mpath) as fh:
                merged = json.load(fh)
        merged.update({k: float(v) for k, v in m.items()})
        with open(mpath, "w") as fh:
            json.dump(merged, fh)
        print(f"{scene}: " + " ".join(
            f"{k}={v:.4f}" for k, v in m.items() if isinstance(v, float)))
    return visualize_metrics(args.result_dir)


def visualize_metrics(result_dir: str, keys=("AbsRel", "AbsDiff", "SqRel",
                                             "RMSE", "LogRMSE", "r1", "r2",
                                             "r3", "complete", "dist1",
                                             "dist2", "prec", "recal",
                                             "fscore")):
    """Aggregate per-scene metrics.json and print nanmeans
    (reference tools/visualize_metrics.py:7-27)."""
    rows = []
    for f in sorted(os.listdir(result_dir)):
        if f.endswith("_metrics.json"):
            with open(os.path.join(result_dir, f)) as fh:
                rows.append(json.load(fh))
    if not rows:
        print("no metrics found")
        return {}
    means = {k: float(np.nanmean([r.get(k, np.nan) for r in rows])) for k in keys}
    for k, v in means.items():
        print(f"{k:10s} {v:.4f}")
    return means


if __name__ == "__main__":
    main()
