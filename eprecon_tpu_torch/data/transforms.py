"""Fragment transform pipeline (port of eprecon_tpu/data/transforms.py).

Reference: datasets/transforms.py — ResizeImage + pad (:83-119), ToTensor
(:21-38), RandomTransformSpace (:122-429, epoch-deterministic world-frame
augmentation + frustum-bound window snapping + on-the-fly partial GT), and
IntrinsicsPoseToProjection (:41-80).

The per-sample GT TSDF re-fusion (9 views x 3 levels) runs on the device
the transform is given (ops/tsdf_fusion.fuse_frames), CUDA unless the
caller asks for the CPU; the resize runs on the host in PyTorch, with the
half-pixel bilinear mapping of cv2's INTER_LINEAR; everything else is cheap
NumPy. Output arrays are numpy, as the model's inputs and targets need.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.ops import camera as cam
from eprecon_tpu_torch.ops import tsdf_fusion


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def pad_scannet(img: np.ndarray, intrinsics: np.ndarray):
    """1296x968 → 1296x972 vertical pad (reference transforms.py:83-92)."""
    h, w = img.shape[:2]
    if w == 1296 and h == 968:
        img = np.pad(img, ((2, 2), (0, 0)) + ((0, 0),) * (img.ndim - 2))
        intrinsics = intrinsics.copy()
        intrinsics[1, 2] += 2
    return img, intrinsics


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """[H, W(, C)] -> [h, w(, C)] f32 for size (w, h): bilinear with the
    half-pixel mapping and edge clamp of cv2.resize's INTER_LINEAR (no
    antialiasing)."""
    x = torch.from_numpy(np.asarray(img, np.float32))
    x = x[..., None] if x.ndim == 2 else x
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(size[1], size[0]),
                        mode="bilinear", align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0).contiguous().numpy()
    return out[..., 0] if np.ndim(img) == 2 else out


class ResizeImage:
    """Bilinear resize + intrinsics rescale (reference transforms.py:95-116)."""

    def __init__(self, size=(640, 480)):
        self.size = size  # (w, h)

    def __call__(self, data):
        for i, im in enumerate(data["imgs"]):
            im, intr = pad_scannet(im, data["intrinsics"][i])
            h, w = im.shape[:2]
            im = resize_bilinear(im, self.size)
            intr = intr.copy()
            intr[0, :] /= w / self.size[0]
            intr[1, :] /= h / self.size[1]
            data["imgs"][i] = im.astype(np.float32)
            data["intrinsics"][i] = intr
        return data


class IntrinsicsPoseToProjection:
    """Per-view per-scale projection matrices + gravity alignment
    (reference transforms.py:41-80)."""

    def __init__(self, n_views: int, stride: int = 4, n_scales: int = 3):
        self.n_views = n_views
        self.stride = stride
        self.n_scales = n_scales

    def __call__(self, data):
        intr = np.stack(data["intrinsics"]).astype(np.float32)
        poses = np.stack(data["extrinsics"]).astype(np.float32)
        data["proj_matrices"] = cam.projection_matrices(
            intr, poses, self.stride, self.n_scales).astype(np.float32)
        data["world_to_aligned_camera"] = cam.world_to_aligned_camera(
            poses[self.n_views // 2]).astype(np.float32)
        return data


def get_view_frustum(max_depth, size, intr, pose):
    """(reference transforms.py:443-459)"""
    im_h, im_w = size
    d = np.array([0, max_depth, max_depth, max_depth, max_depth])
    xs = (np.array([0, 0, 0, im_w, im_w]) - intr[0, 2]) * d / intr[0, 0]
    ys = (np.array([0, 0, im_h, 0, im_h]) - intr[1, 2]) * d / intr[1, 1]
    pts = np.stack([xs, ys, d])
    pts_h = np.concatenate([pts, np.ones((1, 5))])
    return (pose @ pts_h)[:3]


class RandomTransformSpace:
    """Epoch-deterministic world-frame augmentation + fragment windowing +
    partial-GT construction (reference transforms.py:122-429). The GT
    fusion runs on `device`: CUDA unless the caller passes device="cpu"
    (raises where CUDA is asked for and absent)."""

    def __init__(self, voxel_dim, voxel_size, random_rotation=True,
                 random_translation=True, paddingXY=1.5, paddingZ=0.25,
                 n_layers=3, max_epoch=999, max_depth=3.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.voxel_dim = tuple(voxel_dim)
        self.voxel_size = voxel_size
        self.random_rotation = random_rotation
        self.random_translation = random_translation
        self.max_depth = max_depth
        self.n_layers = n_layers
        self.padding_start = np.array([paddingXY, paddingXY, paddingZ])
        self.padding_end = np.array([paddingXY, paddingXY, 0.0])
        rng = np.random.default_rng(31)
        self.random_r = rng.random(max_epoch)
        self.random_t = rng.random((max_epoch, 3))

    def epoch_transform(self, origin: np.ndarray, dims_m: np.ndarray,
                        epoch: int) -> np.ndarray:
        """World-frame augmentation matrix T for `epoch` (the
        epoch-deterministic rotation/translation streams; reference
        transforms.py:154-215). Exposed so the dataset can predict window
        placement (scene anchoring) without running the full transform."""
        r = self.random_r[epoch] * 2 * np.pi if self.random_rotation else 0.0
        R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]])
        xmin, ymin, zmin = origin
        xmax, ymax, zmax = origin + dims_m
        corners = R @ np.array([[xmin, xmin, xmax, xmax],
                                [ymin, ymax, ymin, ymax]])
        start = (np.array([corners[0].min(), corners[1].min(), zmin])
                 - self.padding_start)
        end = -dims_m + np.array([corners[0].max(), corners[1].max(), zmax]) \
            + self.padding_end
        t = self.random_t[epoch] if self.random_translation else np.full(3, .5)
        t = t * start + (1 - t) * end - origin
        T = np.eye(4)
        T[:2, :2] = R
        T[:3, 3] = -t
        return T

    def window_origin(self, frustum_pts: np.ndarray,
                      vol_origin: np.ndarray) -> np.ndarray:
        """Fragment window origin (fine voxels, relative to `vol_origin`)
        from the union of (already-transformed) per-view frustum points —
        the placement rule of _window_and_gt, factored out so dataset-side
        anchor prediction and data/extent.py sizing share ONE implementation."""
        center = (np.array([(frustum_pts[0].min() + frustum_pts[0].max()) / 2,
                            (frustum_pts[1].min() + frustum_pts[1].max()) / 2,
                            -0.2]) - vol_origin) / self.voxel_size
        s = 2 ** self.n_layers
        center[:2] = np.round(center[:2] / s) * s
        center[2] = np.floor(center[2] / s) * s
        org = np.zeros(3)
        org[:2] = center[:2] - np.array(self.voxel_dim[:2]) // 2
        org[2] = center[2]
        return org

    def __call__(self, data):
        origin = np.asarray(data["vol_origin"], np.float64)
        if not (self.random_rotation or self.random_translation) \
                or "tsdf_list_full" not in data:
            # Identity transform (test mode / no-GT inference): world coords
            # are NOT shifted, so keep reporting the scene's true vol_origin.
            # The reference zeroes it here too (transforms.py:157-160) but
            # its global map is an unbounded sparse union; OUR dense global
            # volume anchors at vol_origin (scene_global_origin), and a
            # zeroed origin under unshifted poses anchored the volume ~the
            # whole scene extent away from the geometry, and every edge
            # fragment clamped.
            T = np.eye(4)
            data["extrinsics"] = [T @ e for e in data["extrinsics"]]
            data["vol_origin"] = origin.astype(np.float32)
            return self._window_and_gt(data, np.linalg.inv(T), origin)
        else:
            epoch = int(data.get("epoch", 0))
            dim_old = np.array(data["tsdf_list_full"][0].shape) * self.voxel_size
            T = self.epoch_transform(origin, dim_old, epoch)

        data["extrinsics"] = [T @ e for e in data["extrinsics"]]
        data["vol_origin"] = np.zeros(3, np.float32)
        return self._window_and_gt(data, np.linalg.inv(T), origin)

    def _window_and_gt(self, data, inv_T, old_origin):
        # frustum bounds → snapped fragment origin (reference :236-258)
        bnds = np.stack([np.full(3, np.inf), np.full(3, -np.inf)], axis=1)
        for i in range(len(data["imgs"])):
            size = data["imgs"][i].shape[:2]
            pts = get_view_frustum(self.max_depth, size,
                                   data["intrinsics"][i], data["extrinsics"][i])
            bnds[:, 0] = np.minimum(bnds[:, 0], pts.min(1))
            bnds[:, 1] = np.maximum(bnds[:, 1], pts.max(1))
        # z center -0.2 is ABSOLUTE world z (ScanNet convention: floor at
        # world z=0; reference transforms.py:247) — deliberately NOT
        # vol_origin-relative: the GT volume's z origin sits metres below
        # the floor (frustum free space), while the window must start just
        # under the geometry. Placement math shared with dataset-side anchor
        # prediction via window_origin().
        org = self.window_origin(bnds, data["vol_origin"])
        vol_origin_partial = (org * self.voxel_size + data["vol_origin"]).astype(np.float32)
        data["vol_origin_partial"] = vol_origin_partial

        if "depth" not in data:
            return data

        depths = np.stack(data["depth"]).astype(np.float32)
        intr = np.stack(data["intrinsics"]).astype(np.float32)
        poses = np.stack(data["extrinsics"]).astype(np.float32)

        # intrinsics correspond to the (resized) color frames; rescale to the
        # depth resolution for fusion. Identity on ScanNet (depth is already
        # 640x480 == the resize target), required for other sources.
        ih, iw = data["imgs"][0].shape[:2]
        dh, dw = depths.shape[1:3]
        if (dh, dw) != (ih, iw):
            s = np.diag([dw / iw, dh / ih, 1.0]).astype(np.float32)
            intr = np.einsum("ij,vjk->vik", s, intr)

        # partial GT by on-the-fly fusion per level (reference :281-298),
        # on the device
        on_dev = lambda a: torch.from_numpy(a).to(self.device)
        depths_d, intr_d, poses_d = on_dev(depths), on_dev(intr), on_dev(poses)
        origin_d = on_dev(vol_origin_partial)
        data["tsdf_list"], data["occ_list"] = [], []
        for l in range(self.n_layers):
            dim_l = tuple(v // 2 ** l for v in self.voxel_dim)
            t, wt = tsdf_fusion.fuse_frames(
                depths_d, intr_d, poses_d, origin_d, dim_l,
                self.voxel_size * 2 ** l, margin=3)
            t, wt = t.cpu().numpy(), wt.cpu().numpy()
            data["tsdf_list"].append(t)
            data["occ_list"].append((np.abs(t) < 0.999) & (wt > 1))

        # sample full-scene label volumes into the fragment window
        # (nearest-neighbor; reference :322-353 grid_sample nearest)
        if "semantic_list_full" in data:
            coords = _window_world_coords(self.voxel_dim, self.voxel_size,
                                          vol_origin_partial)
            world = (inv_T[:3, :3] @ coords.T + inv_T[:3, 3:4]).T
            idx = np.round((world - old_origin) / self.voxel_size).astype(int)
            full = data["semantic_list_full"][0]
            inb = ((idx >= 0) & (idx < np.array(full.shape))).all(1)
            ii = np.clip(idx, 0, np.array(full.shape) - 1)
            sem = np.where(inb, full[ii[:, 0], ii[:, 1], ii[:, 2]], 0)
            ins_full = data["instance_list_full"][0]
            ins = np.where(inb, ins_full[ii[:, 0], ii[:, 1], ii[:, 2]], 0)
            data["semantic"] = sem.reshape(self.voxel_dim).astype(np.int32)
            data["instance"] = ins.reshape(self.voxel_dim).astype(np.int32)
            data["semantic"] = np.where(data["occ_list"][0], data["semantic"], 0)
            data["instance"] = np.where(data["occ_list"][0], data["instance"], 0)
            for k in ("semantic_list_full", "instance_list_full", "rgb_list_full"):
                data.pop(k, None)
        data.pop("tsdf_list_full", None)
        data.pop("depth", None)
        return data


def _window_world_coords(voxel_dim, voxel_size, origin):
    xs = np.arange(voxel_dim[0])
    ys = np.arange(voxel_dim[1])
    zs = np.arange(voxel_dim[2])
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    return g * voxel_size + origin
