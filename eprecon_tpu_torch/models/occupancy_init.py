"""Occupancy initialization (port of eprecon_tpu/models/occupancy_init.py;
reference models/occupancy_initialization.py:11-182).

Per view, fuse the 3 FPN scales into a 32-channel matching map at 1/8
resolution; back-project every voxel of the 48^3 init grid into every view
and take the cross-view feature variance (the CUDA kernel on the card);
a sparse-ELAN + residual subM-conv stack turns it into occupancy logits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eprecon_tpu_torch.models.blocks import (Conv2dBlock, Conv2dResidualBlock,
                                             FusionBlock)
from eprecon_tpu_torch.models.dense3d import (MaskedBatchNorm3d,
                                              MaskedLayerNorm3d,
                                              Sparse3dELANDense,
                                              SubMConv3dDense)
from eprecon_tpu_torch.ops.back_project import back_project_variance_window


class InitFeatureFusion(nn.Module):
    """Per-view multi-scale fusion to the 1/8-res matching feature map
    (reference occupancy_initialization.py:41-58)."""

    def __init__(self, chs: Sequence[int], ch_down: int = 32,
                 use_running_average: bool = False):
        """chs: FPN channels fine -> coarse, e.g. (24, 40, 80)."""
        super().__init__()
        ura = use_running_average
        c_fine, c_mid, c_coarse = chs
        self.FusionBlock_0 = FusionBlock(c_coarse, ura)
        self.FusionBlock_1 = FusionBlock(c_mid, ura)
        self.FusionBlock_2 = FusionBlock(c_fine, ura)
        self.Conv2dBlock_0 = Conv2dBlock(sum(chs), ch_down, 1, ura)
        for i in range(4):
            setattr(self, f"Conv2dResidualBlock_{i}",
                    Conv2dResidualBlock(ch_down, 3, ura))

    def forward(self, feats_1x, feats_2x, feats_4x):
        """feats_kx: [V, h, w, C] NHWC; 1x = coarsest (1/16), 4x = finest."""
        f1 = self.FusionBlock_0(feats_1x)
        f2 = self.FusionBlock_1(feats_2x)
        f4 = self.FusionBlock_2(feats_4x)
        # coarsest x2 bilinear (half-pixel, edge-clamped == jax.image.resize
        # when upsampling), finest 2x2 average-pooled: all at 1/8
        f1 = F.interpolate(f1.movedim(-1, 1), scale_factor=2, mode="bilinear",
                           align_corners=False).movedim(1, -1)
        f4 = F.avg_pool2d(f4.movedim(-1, 1), 2).movedim(1, -1)
        fused = self.Conv2dBlock_0(torch.cat([f1, f2, f4], dim=-1))
        for i in range(4):
            fused = getattr(self, f"Conv2dResidualBlock_{i}")(fused)
        return fused


class OccupancyInitialization(nn.Module):
    """Occupancy logits over the dense init grid (48^3 at init_stage=1)."""

    def __init__(self, chs: Sequence[int], ch_down: int = 32,
                 use_running_average: bool = False):
        super().__init__()
        ura = use_running_average
        self.ch_down = ch_down
        self.InitFeatureFusion_0 = InitFeatureFusion(chs, ch_down, ura)
        self.norm0 = MaskedBatchNorm3d(ch_down, ura)
        self.Sparse3dELANDense_0 = Sparse3dELANDense(ch_down, ch_down)
        for i in range(1, 4):
            setattr(self, f"subm{i}", SubMConv3dDense(ch_down, ch_down))
            setattr(self, f"norm{i}", MaskedLayerNorm3d(ch_down))
        self.subm4 = SubMConv3dDense(ch_down, 1)
        self.norm4 = MaskedBatchNorm3d(1, ura)

    def forward(self, features_pyramid, origin, voxel_size: float, proj,
                grid_shape: Tuple[int, int, int], interval: int,
                min_view_number: int = 2):
        """features_pyramid: 3 tensors [V, B, H, W, C] fine -> coarse;
        origin [B, 3]; proj [V, B, 4, 4] at the 1/8 feature scale.
        Returns occ logits [B, X, Y, Z], valid mask (count >= min views)
        and the view count, both [B, X, Y, Z]."""
        f_fine, f_mid, f_coarse = features_pyramid
        bs = f_mid.shape[1]
        fused = torch.stack([self.InitFeatureFusion_0(
            f_coarse[:, b], f_mid[:, b], f_fine[:, b]) for b in range(bs)], 1)

        # the dense grid as a window per batch element: the rows of the
        # reference's coordinate list (b, x, y, z) * interval, in its order
        per_batch = [back_project_variance_window(
            grid_shape, interval, origin[b:b + 1], voxel_size, fused[:, b:b + 1],
            proj[:, b:b + 1]) for b in range(bs)]
        var, count = (per_batch[0] if bs == 1 else
                      [torch.cat(x) for x in zip(*per_batch)])
        count_vol = count.reshape(bs, *grid_shape)
        mask = count_vol >= min_view_number
        h = var.reshape(bs, *grid_shape, self.ch_down)

        h = self.norm0(h, mask)
        h = self.Sparse3dELANDense_0(h, mask)
        for i in range(1, 4):
            r = F.relu(getattr(self, f"subm{i}")(h, mask)) + h
            h = getattr(self, f"norm{i}")(r, mask)
        out = self.norm4(self.subm4(h, mask), mask)
        return out[..., 0], mask, count_vol
