"""ScanNet fragment dataset (port of eprecon_tpu/data/scannet.py).

Reference: datasets/scannet.py:9-172 (ScanNetDataset) — reads
`fragments_{split}.pkl` metas produced by the GT generator, loads per-view
jpg/depth-png + intrinsics/poses, and the full-scene GT volumes with a small
cache. File layout is identical to the reference's so an existing prepared
ScanNet tree works unchanged:

  <datapath>/fragments_{train,val,test}.pkl
  <datapath>/<scene>/color/<id>.jpg, depth/<id>.png,
             intrinsic/intrinsic_color.txt, pose/<id>.txt
  <tsdf_dir>/<scene>/full_tsdf_layer{l}.npz (+ semantic/instance layers)

Images are decoded with cv2 (and their size read with PIL), imported when
a frame is read: a real ScanNet tree needs them on the host. The readers
`_read_img`, `_read_depth`, `_read_cam` and `_color_size` are the only
methods that touch frame files, so a subclass can serve frames from
elsewhere.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_def(name: str):
    """reference datasets/__init__.py:5-9 equivalent."""
    return DATASET_REGISTRY[name]


@register_dataset("scannet")
class ScanNetDataset:
    def __init__(self, datapath: str, mode: str, transforms, nviews: int,
                 n_scales: int = 2, tsdf_dir: str = "all_tsdf_9",
                 max_cache: int = 50, epoch: int = 0,
                 load_labels: bool = True):
        self.datapath = datapath
        self.mode = mode
        self.transforms = transforms
        self.nviews = nviews
        self.n_scales = n_scales
        self.tsdf_dir = tsdf_dir
        self.max_cache = max_cache
        self.epoch = epoch
        self.load_labels = load_labels
        self.cache: Dict[str, dict] = {}
        self.metas = self._load_metas()
        self.source_path = os.path.join(datapath, "scans_test" if mode == "test"
                                        else "scans")

    def _load_metas(self) -> List[dict]:
        split = {"train": "train", "val": "val", "test": "test"}[self.mode]
        with open(os.path.join(self.datapath, self.tsdf_dir,
                               f"fragments_{split}.pkl"), "rb") as f:
            metas = pickle.load(f)
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_img(self, path):
        import cv2

        img = cv2.imread(path)  # BGR, matching the reference's pixel means
        return img.astype(np.float32)

    def _read_depth(self, path):
        import cv2

        d = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
        d[d > 3.0] = 0.0  # reference datasets/scannet.py depth clamp
        return d

    def _read_cam(self, scene, vid):
        intr = np.loadtxt(os.path.join(self.source_path, scene, "intrinsic",
                                       "intrinsic_color.txt"))[:3, :3]
        pose = np.loadtxt(os.path.join(self.source_path, scene, "pose",
                                       f"{vid}.txt"))
        return intr.astype(np.float32), pose.astype(np.float32)

    def _read_scene_volumes(self, scene) -> dict:
        """Full-scene GT volumes with LRU-ish cache
        (reference datasets/scannet.py:65-94)."""
        if scene in self.cache:
            return self.cache[scene]
        root = os.path.join(self.datapath, self.tsdf_dir, scene)
        full = {"tsdf_list_full": []}
        for l in range(self.n_scales + 1):
            full["tsdf_list_full"].append(
                np.load(os.path.join(root, f"full_tsdf_layer{l}.npz"),
                        allow_pickle=True)["arr_0"])
        if self.load_labels:
            for key, stem in (("semantic_list_full", "full_semantic_layer"),
                              ("instance_list_full", "full_instance_layer")):
                path0 = os.path.join(root, f"{stem}_interpolate0.npz")
                if not os.path.exists(path0):
                    path0 = os.path.join(root, f"{stem}0.npz")
                if os.path.exists(path0):
                    full[key] = [np.load(path0, allow_pickle=True)["arr_0"]]
        if len(self.cache) >= self.max_cache:
            self.cache.pop(next(iter(self.cache)))
        self.cache[scene] = full
        return full

    def image_paths(self, idx: int):
        """(color_paths, depth_paths) of fragment idx — the submit side of
        the native prefetching loader (data/native_loader.py)."""
        meta = self.metas[idx]
        scene = meta["scene"]
        imgs = [os.path.join(self.source_path, scene, "color", f"{v}.jpg")
                for v in meta["image_ids"]]
        depths = [os.path.join(self.source_path, scene, "depth", f"{v}.png")
                  for v in meta["image_ids"]]
        return imgs, depths

    def _color_size(self, scene: str, vid) -> tuple:
        """Original (h, w) of a scene's color frames (header read, cached) —
        needed to adjust intrinsics for natively pre-resized images."""
        if not hasattr(self, "_size_cache"):
            self._size_cache = {}
        if scene not in self._size_cache:
            from PIL import Image

            with Image.open(os.path.join(self.source_path, scene, "color",
                                         f"{vid}.jpg")) as im:
                w, h = im.size
            self._size_cache[scene] = (h, w)
        return self._size_cache[scene]

    def _find_rts(self):
        """The RandomTransformSpace stage of the transform pipeline (None if
        absent) — needed to predict window placement for scene anchoring."""
        if not hasattr(self, "_rts"):
            self._rts = None
            stages = getattr(self.transforms, "transforms", [])
            for t in stages:
                if hasattr(t, "window_origin") and hasattr(t, "epoch_transform"):
                    self._rts = t
        return self._rts

    def _scene_frustums(self, scene: str):
        """Per-fragment stacked view-frustum corner points (world frame,
        untransformed), cached per scene. Frustum geometry is invariant to
        the ResizeImage intrinsics rescale (same FOV), so raw color
        intrinsics + raw image size are exact."""
        if not hasattr(self, "_frustum_cache"):
            self._frustum_cache = {}
        if scene not in self._frustum_cache:
            from eprecon_tpu_torch.data.transforms import get_view_frustum

            intr = np.loadtxt(os.path.join(
                self.source_path, scene, "intrinsic",
                "intrinsic_color.txt"))[:3, :3]
            size = self._color_size(
                scene, next(m for m in self.metas
                            if m["scene"] == scene)["image_ids"][0])
            if size == (968, 1296):  # pad_scannet: 968 -> 972, cy += 2
                intr = intr.copy()
                intr[1, 2] += 2
                size = (972, 1296)
            rts = self._find_rts()
            frs = []
            for m in self.metas:
                if m["scene"] != scene:
                    continue
                pts = np.concatenate(
                    [get_view_frustum(
                        rts.max_depth, size, intr,
                        np.loadtxt(os.path.join(self.source_path, scene,
                                                "pose", f"{fid}.txt")))
                     for fid in m["image_ids"]], axis=1)
                frs.append(pts)
            self._frustum_cache[scene] = frs
        return self._frustum_cache[scene]

    def scene_anchor(self, scene: str, epoch: int):
        """World-frame minimum fragment-window origin over the scene's
        fragments for this epoch (in the epoch's transformed frame).

        Anchoring the dense global volume here instead of at vol_origin
        shrinks the required global_extent from the all-epoch union of the
        translation-augmentation sweep to the largest single-epoch window
        span (measured [448,384,352] -> [216,216,96] fine voxels on the
        production synthetic scenes) — the reference never needs this
        because its global map is an unbounded sparse union
        (gru_fusion.py:91-98). Returns None when the pipeline has no
        RandomTransformSpace stage."""
        rts = self._find_rts()
        if rts is None:
            return None
        if not hasattr(self, "_anchor_cache"):
            self._anchor_cache = {}
        key = (scene, int(epoch))
        if key not in self._anchor_cache:
            frs = self._scene_frustums(scene)
            origin = np.asarray(
                next(m for m in self.metas
                     if m["scene"] == scene)["vol_origin"], np.float64)
            augment = (self.mode == "train"
                       and (rts.random_rotation or rts.random_translation))
            if augment:
                vols = self._read_scene_volumes(scene)
                dims_m = (np.array(vols["tsdf_list_full"][0].shape)
                          * rts.voxel_size)
                T = rts.epoch_transform(origin, dims_m, int(epoch))
                vol_origin = np.zeros(3)
            else:
                T = np.eye(4)
                vol_origin = origin
            orgs = np.stack([
                rts.window_origin(T[:3, :3] @ p + T[:3, 3:4], vol_origin)
                for p in frs])
            self._anchor_cache[key] = (orgs.min(0) * rts.voxel_size
                                       + vol_origin).astype(np.float32)
            if len(self._anchor_cache) > 4 * self.max_cache:
                self._anchor_cache.pop(next(iter(self._anchor_cache)))
        return self._anchor_cache[key]

    def _build_sample(self, idx: int, imgs, depths, intrinsics, poses) -> dict:
        meta = self.metas[idx]
        scene = meta["scene"]
        vols = self._read_scene_volumes(scene)
        data = dict(
            imgs=imgs, depth=depths, intrinsics=intrinsics, extrinsics=poses,
            scene=scene, fragment=f"{scene}_{meta['fragment_id']}",
            vol_origin=np.asarray(meta["vol_origin"], np.float32),
            epoch=self.epoch,
            **{k: [v.copy() for v in vs] if isinstance(vs, list) else vs
               for k, vs in vols.items()},
        )
        if self.transforms is not None:
            data = self.transforms(data)
            anchor = self.scene_anchor(scene, self.epoch)
            if anchor is not None:
                data["global_anchor"] = anchor
        return data

    def getitem_decoded(self, idx: int, imgs: np.ndarray,
                        depths: np.ndarray) -> dict:
        """Build a sample from natively pre-decoded images.

        imgs [V, out_h, out_w, 3] f32 BGR (ScanNet pad + resize already
        applied by the C++ loader); depths [V, out_h, out_w] f32 meters.
        Intrinsics get the same pad+rescale the python ResizeImage path
        applies (reference datasets/transforms.py:83-116), computed from the
        original color size, so the downstream transform chain is a no-op on
        geometry.
        """
        meta = self.metas[idx]
        scene = meta["scene"]
        out_h, out_w = imgs.shape[1:3]
        h0, w0 = self._color_size(scene, meta["image_ids"][0])
        intrinsics, poses = [], []
        for vid in meta["image_ids"]:
            intr, pose = self._read_cam(scene, vid)
            intr = intr.copy()
            h, w = h0, w0
            if w == 1296 and h == 968:  # pad_scannet
                intr[1, 2] += 2
                h = 972
            intr[0, :] /= w / out_w
            intr[1, :] /= h / out_h
            intrinsics.append(intr)
            poses.append(pose)
        return self._build_sample(idx, list(imgs), list(depths), intrinsics,
                                  poses)

    def __getitem__(self, idx: int) -> dict:
        meta = self.metas[idx]
        scene = meta["scene"]
        imgs, depths, intrinsics, poses = [], [], [], []
        for vid in meta["image_ids"]:
            imgs.append(self._read_img(
                os.path.join(self.source_path, scene, "color", f"{vid}.jpg")))
            depths.append(self._read_depth(
                os.path.join(self.source_path, scene, "depth", f"{vid}.png")))
            intr, pose = self._read_cam(scene, vid)
            intrinsics.append(intr)
            poses.append(pose)
        return self._build_sample(idx, imgs, depths, intrinsics, poses)
