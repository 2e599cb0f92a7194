"""TSDF fusion of depth frames into a dense volume, plain PyTorch (port of
eprecon_tpu/ops/tsdf_fusion.py:20-103; reference tools/tsdf_fusion/
fusion.py:440-485): nearest-pixel depth lookup, truncation to [., 1],
running weighted average. It makes the ground truth of the synthetic
fragments, on the model's device the per-sample GT of the data pipeline
(data/transforms.py), and the full-scene GT of tools/generate_gt.py.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from eprecon_tpu_torch.ops.grid import dense_coords


class TSDFVolume(NamedTuple):
    """A dense TSDF volume: tsdf [X, Y, Z] f32 (init 1), weight (init 0),
    origin [3] (world position of voxel (0, 0, 0)), all on one device."""
    tsdf: torch.Tensor
    weight: torch.Tensor
    origin: torch.Tensor
    voxel_size: float
    sdf_trunc: float

    def integrate(self, depth_im: torch.Tensor, cam_intr: torch.Tensor,
                  cam_pose: torch.Tensor) -> "TSDFVolume":
        """The volume with one more depth frame fused in (`integrate`)."""
        tsdf, weight = integrate(self.tsdf, self.weight, self.origin,
                                 self.voxel_size, self.sdf_trunc, depth_im,
                                 cam_intr, cam_pose)
        return self._replace(tsdf=tsdf, weight=weight)


def make_volume(vol_dim: Sequence[int], origin, voxel_size: float,
                margin: int = 3, device=None) -> TSDFVolume:
    """An empty volume of `vol_dim` voxels at `origin` on `device`, its
    truncation `margin` voxels."""
    vol_dim = tuple(int(d) for d in vol_dim)
    return TSDFVolume(
        tsdf=torch.ones(vol_dim, device=device),
        weight=torch.zeros(vol_dim, device=device),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=device),
        voxel_size=float(voxel_size), sdf_trunc=float(margin * voxel_size))


def integrate(tsdf: torch.Tensor, weight: torch.Tensor, origin: torch.Tensor,
              voxel_size: float, sdf_trunc: float, depth_im: torch.Tensor,
              cam_intr: torch.Tensor, cam_pose: torch.Tensor,
              obs_weight: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate one depth frame into (tsdf, weight) [X, Y, Z] f32.

    depth_im [H, W] meters (0 = invalid); cam_intr [3, 3]; cam_pose [4, 4]
    camera-to-world. Returns the new (tsdf, weight)."""
    im_h, im_w = depth_im.shape
    shape = tsdf.shape
    coords = dense_coords(shape, tsdf.device).reshape(-1, 3).float()
    world = origin[None, :] + voxel_size * coords
    world2cam = torch.linalg.inv(cam_pose)
    cam = world @ world2cam[:3, :3].T + world2cam[:3, 3]
    fx, fy = cam_intr[0, 0], cam_intr[1, 1]
    cx, cy = cam_intr[0, 2], cam_intr[1, 2]
    pix_z = cam[:, 2]
    safe_z = torch.where(pix_z.abs() < 1e-12, torch.full_like(pix_z, 1e-12),
                         pix_z)
    pix_x = torch.round(cam[:, 0] * fx / safe_z + cx).long()
    pix_y = torch.round(cam[:, 1] * fy / safe_z + cy).long()
    valid_pix = ((pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h)
                 & (pix_z > 0))
    depth_val = depth_im[pix_y.clamp(0, im_h - 1), pix_x.clamp(0, im_w - 1)]
    depth_diff = depth_val - pix_z
    dist = torch.clamp(depth_diff / sdf_trunc, max=1.0)
    valid = valid_pix & (depth_val > 0) & (depth_diff >= -sdf_trunc)
    t, w = tsdf.reshape(-1), weight.reshape(-1)
    w_new = w + obs_weight
    t_upd = (w * t + obs_weight * dist) / w_new
    return (torch.where(valid, t_upd, t).reshape(shape),
            torch.where(valid, w_new, w).reshape(shape))


def fuse_frames(depths: torch.Tensor, intrinsics: torch.Tensor,
                poses: torch.Tensor, origin: torch.Tensor,
                vol_dim: Sequence[int], voxel_size: float, margin: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse frames [V, H, W] (intrinsics [V, 3, 3], poses [V, 4, 4]) into
    a fresh volume of `vol_dim` voxels at `origin`. Returns (tsdf, weight)."""
    vol = make_volume(vol_dim, origin, voxel_size, margin, depths.device)
    for d, k, p in zip(depths, intrinsics, poses):
        vol = vol.integrate(d, k, p)
    return vol.tsdf, vol.weight


def occupancy_from_tsdf(tsdf: torch.Tensor, weight: torch.Tensor,
                        min_weight: float = 1.0) -> torch.Tensor:
    """Occupancy GT: |tsdf| < 0.999 observed by more than `min_weight`
    views (reference datasets/transforms.py:295-297)."""
    return (tsdf < 0.999) & (tsdf > -0.999) & (weight > min_weight)
