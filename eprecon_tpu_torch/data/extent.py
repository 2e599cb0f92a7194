"""Dense-global-volume sizing from a dataset's actual window placements
(port of eprecon_tpu/data/extent.py).

The reference's global map is an unbounded sparse union
(models/gru_fusion.py:91-98) and never needs sizing. The global scene
state here is DENSE with extent `cfg.model.global_extent`, so a scene
larger than the volume, or a fragment window placed outside it, hits the
window clamp and the reconstruction is relocated (inference warns:
inference/pipeline.py clip detection).

This module sizes (extent, origin_margin) EXACTLY by replicating the data
pipeline's window placement for every fragment meta, through the SAME
implementation the pipeline runs (RandomTransformSpace.epoch_transform /
.window_origin — data/transforms.py):

- identity branch (test mode / no-GT inference): frustum-union xy center,
  absolute z = -0.2 m, vol_origin reported true;
- augmentation branch (train mode): the epoch-deterministic rotation /
  translation streams (rng(31)) are swept for every requested epoch.

Anchoring (cfg.model.scene_anchor) decides what the extent must cover:

- "window_union" (default): the global volume anchors at the per-(scene,
  epoch) window-union lo (data/scannet.py scene_anchor), so the extent only
  covers the largest SINGLE-EPOCH window span.
- "vol_origin": the translation augmentation sweeps windows across the
  padded scene, so coverage needs the all-epoch union and `cap` usually
  binds (the cap only clamps the GRU global-map writeback for outlier
  placements; per-fragment supervision is window-local and exact).

Wire-up: set `model.global_extent_auto true` on the CLI and
run_train/run_test resolve the extent from the dataset before building the
model (eprecon_tpu_torch/main.py). The first color frame of each scene is
decoded with cv2 for its size.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

# default cap for auto-sized TRAIN volumes (fine voxels): the JAX
# package's, kept so that both packages size a run alike
DEFAULT_TRAIN_CAP = (320, 256, 192)
DEFAULT_TRAIN_CAP_MARGIN = 96


def _pad_scannet_size(size, intr):
    """Size/intrinsics effect of transforms.pad_scannet (968 -> 972)."""
    h, w = size
    if (h, w) == (968, 1296):
        intr = intr.copy()
        intr[1, 2] += 2
        return (972, w), intr
    return size, intr


def fit_global_extent(cfg, mode: str, epochs: Optional[int] = None,
                      cap: Optional[Sequence[int]] = None,
                      cap_margin: Optional[int] = None,
                      round_to: int = 32) -> Tuple[Tuple[int, int, int], int]:
    """(global_extent, origin_margin) covering every fragment window.

    cfg: full Config (voxel size, n_vox, paddings, epochs, paths).
    mode: "train" sweeps the augmentation stream over `epochs`
    (default cfg.train.epochs) and applies `cap`; "test" sizes the identity
    placement of the test split exactly.
    """
    from eprecon_tpu_torch.data.transforms import (RandomTransformSpace,
                                                   get_view_frustum)

    m = cfg.model
    vs = float(m.voxel_size)
    win = np.asarray(m.n_vox)
    train = mode == "train"
    epochs = epochs or cfg.train.epochs
    datapath = cfg.train.path if train else cfg.test.path
    augment = train and (cfg.train.random_rotation_3d
                         or cfg.train.random_translation_3d)
    # the pipeline's own placement implementation — per-flag streams and the
    # frustum-union snap rule included
    rts = RandomTransformSpace(
        m.n_vox, vs,
        random_rotation=cfg.train.random_rotation_3d and train,
        random_translation=cfg.train.random_translation_3d and train,
        paddingXY=cfg.train.pad_xy_3d, paddingZ=cfg.train.pad_z_3d,
        device="cpu")  # placement only: no fusion runs
    snap = 2 ** rts.n_layers

    splits = ("train", "val") if train else ("test",)
    metas = []
    for split in splits:
        p = os.path.join(datapath, "all_tsdf_9", f"fragments_{split}.pkl")
        if not os.path.exists(p):
            p = os.path.join(datapath, f"fragments_{split}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                metas += [(split, x) for x in pickle.load(f)]
    if not metas:
        raise FileNotFoundError(f"no fragment pkls under {datapath}")

    # mirror data/scannet.py source_path (scans_test may be a symlink)
    source = os.path.join(datapath, "scans_test" if not train else "scans")
    if not os.path.isdir(source):
        source = os.path.join(datapath, "scans")
    if not os.path.isdir(source):
        source = datapath

    # per-scene: camera cache + per-fragment stacked frustum points
    cache = {}
    scenes: dict = {}
    for split, meta in metas:
        scene = meta["scene"]
        if scene not in cache:
            sd = os.path.join(source, scene)
            intr = np.loadtxt(os.path.join(
                sd, "intrinsic", "intrinsic_color.txt"))[:3, :3]
            import cv2

            c0 = sorted(glob.glob(os.path.join(sd, "color", "*.jpg")))
            img = cv2.imread(c0[0])
            size, intr = _pad_scannet_size(img.shape[:2], intr)
            gt = os.path.join(datapath, "all_tsdf_9", scene,
                              "full_tsdf_layer0.npz")
            d = np.load(gt)
            dims = d[d.files[0]].shape
            cache[scene] = (sd, intr, size, np.asarray(dims))
        sd, intr, size, dims = cache[scene]
        pts = np.concatenate(
            [get_view_frustum(rts.max_depth, size, intr,
                              np.loadtxt(os.path.join(sd, "pose",
                                                      f"{fid}.txt")))
             for fid in meta["image_ids"]], axis=1)
        scenes.setdefault(scene, []).append(pts)

    anchored = m.scene_anchor == "window_union"
    span = np.zeros(3)          # anchored: max per-(scene, epoch) span
    lo = np.zeros(3)            # vol_origin: global union
    hi = np.zeros(3)
    for scene, frs in scenes.items():
        sd, intr, size, dims = cache[scene]
        origin = np.asarray(
            next(x["vol_origin"] for s, x in metas
                 if x["scene"] == scene), np.float64)
        sweeps = range(epochs) if augment else (None,)
        for ep in sweeps:
            if ep is None:
                T, vol_origin = np.eye(4), origin
            else:
                T = rts.epoch_transform(origin, dims * vs, ep)
                vol_origin = np.zeros(3)
            orgs = np.stack([
                rts.window_origin(T[:3, :3] @ p + T[:3, 3:4], vol_origin)
                for p in frs])
            if anchored:
                span = np.maximum(span, orgs.max(0) + win - orgs.min(0))
            else:
                lo = np.minimum(lo, orgs.min(0))
                hi = np.maximum(hi, orgs.max(0) + win)

    if anchored:
        margin = max(int(m.origin_margin) // snap * snap, snap)
        need = [int(np.ceil((s + 2 * margin) / round_to) * round_to)
                for s in span]
    else:
        margin = int(np.ceil(max(0, -lo.min()) / snap) * snap)
        margin = max(margin, int(m.origin_margin))
        # guarantee scene_global_origin honors the FULL margin: it spends at
        # most half the slack (extent - window) below vol_origin, so extent
        # must be at least window + 2*margin per axis or the applied margin
        # silently halves and fragments relocate
        need = [int(np.ceil(max(h, w + 2 * margin) / round_to) * round_to)
                for h, w in zip(hi + margin, win)]
    ext = need
    if train:
        cap = tuple(cap or DEFAULT_TRAIN_CAP)
        margin = min(margin, cap_margin or DEFAULT_TRAIN_CAP_MARGIN)
        # the cap is a memory budget, not a shape constraint: a need whose
        # VOLUME fits the cap's volume is affordable regardless of its
        # aspect ratio (anchored spans are scene-shaped, e.g. [288,288,160]
        # = 13.3M voxels < the cap's 15.7M); only clamp per-axis when the
        # volume itself exceeds the budget
        if np.prod(need) > np.prod(cap):
            ext = [min(e, c) for e, c in zip(ext, cap)]
        if ext != need:
            if anchored:
                detail = "windows beyond the capped span clamp at the top"
            else:
                applied = [min(margin, (e - w) // 2 // snap * snap)
                           for e, w in zip(ext, win)]
                detail = (f"applied per-axis margins {applied} of requested "
                          f"{margin}")
            print(f"fit_global_extent: train cap truncates coverage — "
                  f"need extent {need}, capped to {ext} ({detail}); "
                  f"out-of-volume fragment windows will clamp "
                  f"(GRU writeback relocated)")
    return tuple(ext), margin
