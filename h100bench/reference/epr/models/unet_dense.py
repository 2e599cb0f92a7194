"""Dense-window 3D U-Net + ConvGRU (port of eprecon_tpu/models/unet_dense.py;
reference SPVCNN / SConv3d / ConvGRU, models/modules.py:75-222).

Like the JAX module, the aligned-camera coordinates enter as three input
features and the point branch is identity at L0 / trilinear upsampling
from coarser levels. Dropout (training only) is not part of this port.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.epr.models.dense3d import (ConvDown3dDense, ConvUp3dDense,
                                              DenseResidualBlock,
                                              MaskedBatchNorm3d,
                                              SubMConv3dDense,
                                              upsample_trilinear)
from h100bench.reference.epr.models.layers import Dense, mask3


def unet_channels(cr: float):
    return [int(cr * v) for v in (32, 64, 128, 96, 96)]


class DenseUNet(nn.Module):
    """3-level U-Net with SPVCNN's channel plan cs = [32,64,128,96,96] * cr."""

    def __init__(self, in_ch: int, cr: float = 1.0,
                 use_running_average: bool = False):
        super().__init__()
        cs = unet_channels(cr)
        ura = use_running_average
        self.stem_conv = SubMConv3dDense(in_ch, cs[0])
        self.stem_bn = MaskedBatchNorm3d(cs[0], ura)
        self.down1 = ConvDown3dDense(cs[0], cs[0])
        self.down1_bn = MaskedBatchNorm3d(cs[0], ura)
        self.res1a = DenseResidualBlock(cs[0], cs[1], ura)
        self.res1b = DenseResidualBlock(cs[1], cs[1], ura)
        self.down2 = ConvDown3dDense(cs[1], cs[1])
        self.down2_bn = MaskedBatchNorm3d(cs[1], ura)
        self.res2a = DenseResidualBlock(cs[1], cs[2], ura)
        self.res2b = DenseResidualBlock(cs[2], cs[2], ura)
        self.point_transform0 = Dense(cs[0], cs[2])
        self.pt0_bn = MaskedBatchNorm3d(cs[2], ura)
        self.up1 = ConvUp3dDense(cs[2], cs[3])
        self.up1_bn = MaskedBatchNorm3d(cs[3], ura)
        self.res3a = DenseResidualBlock(cs[3] + cs[1], cs[3], ura)
        self.res3b = DenseResidualBlock(cs[3], cs[3], ura)
        self.up2 = ConvUp3dDense(cs[3], cs[4])
        self.up2_bn = MaskedBatchNorm3d(cs[4], ura)
        self.res4a = DenseResidualBlock(cs[4] + cs[0], cs[4], ura)
        self.res4b = DenseResidualBlock(cs[4], cs[4], ura)
        self.point_transform1 = Dense(cs[2], cs[4])
        self.pt1_bn = MaskedBatchNorm3d(cs[4], ura)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """feats [X, Y, Z, C]; mask [X, Y, Z] -> [X, Y, Z, cs[4]]."""
        x0 = self.stem_bn(self.stem_conv(feats, mask), mask)
        x0 = mask3(F.relu(x0), mask)
        z0 = x0  # voxel_to_point at L0 == identity on the grid

        x1, m1 = self.down1(z0, mask)
        x1 = mask3(F.relu(self.down1_bn(x1, m1)), m1)
        x1 = self.res1b(self.res1a(x1, m1), m1)

        x2, m2 = self.down2(x1, m1)
        x2 = mask3(F.relu(self.down2_bn(x2, m2)), m2)
        x2 = self.res2b(self.res2a(x2, m2), m2)

        # point branch 0: z1 = devox(x2) + relu(bn(lin(z0)))
        z1 = upsample_trilinear(x2, 4)
        pt0 = self.pt0_bn(self.point_transform0(z0), mask)
        z1 = mask3(z1 + F.relu(pt0), mask)

        y3 = maxpool_mean(z1, 4, mask)
        y3 = self.up1(y3, m2, m1)
        y3 = mask3(F.relu(self.up1_bn(y3, m1)), m1)
        y3 = torch.cat([y3, x1], dim=-1)
        y3 = self.res3b(self.res3a(y3, m1), m1)

        y4 = self.up2(y3, m1, mask)
        y4 = mask3(F.relu(self.up2_bn(y4, mask)), mask)
        y4 = torch.cat([y4, x0], dim=-1)
        y4 = self.res4b(self.res4a(y4, mask), mask)

        pt1 = self.pt1_bn(self.point_transform1(z1), mask)
        return mask3(y4 + F.relu(pt1), mask)


def maxpool_mean(vol: torch.Tensor, factor: int,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked mean-pool by an integer factor (point_to_voxel averaging)."""
    x, y, z, c = vol.shape
    f = factor
    v = (vol * mask[..., None]).reshape(x // f, f, y // f, f, z // f, f, c)
    v = v.sum(dim=(1, 3, 5))
    m = mask.reshape(x // f, f, y // f, f, z // f, f).sum(dim=(1, 3, 5))
    return v / m[..., None].clamp(min=1).float()


class DenseSConv3d(nn.Module):
    """Conv(ks3) + pointwise linear residual (reference SConv3d,
    modules.py:178-197)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = SubMConv3dDense(in_ch, features)
        self.point_transform = Dense(in_ch, features)

    def forward(self, x, mask):
        return mask3(self.conv(x, mask) + self.point_transform(x), mask)


class DenseConvGRU(nn.Module):
    """ConvGRU cell (reference ConvGRU, modules.py:200-222) with the z and
    r gates fused into one conv of 2x output channels, the parameter
    layout of the JAX module."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.convzr = DenseSConv3d(hidden_dim + input_dim, 2 * hidden_dim)
        self.convq = DenseSConv3d(hidden_dim + input_dim, hidden_dim)

    def forward(self, h, x, mask):
        zr = self.convzr(torch.cat([h, x], dim=-1), mask)
        z = torch.sigmoid(zr[..., :self.hidden_dim])
        r = torch.sigmoid(zr[..., self.hidden_dim:])
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1), mask))
        return mask3((1 - z) * h + z * q, mask)
