"""Dense-window equivalents of submanifold sparse 3D convolutions
(port of eprecon_tpu/models/dense3d.py; reference models/modules.py:46-452).

A submanifold sparse conv at the active sites equals a dense conv over a
volume whose inactive voxels are zero, read at the active sites; every
module keeps an explicit mask and re-zeroes after each conv. Volumes are
channels-last [X, Y, Z, C] with a bool mask [X, Y, Z]. The JAX package's
ShiftedConv3d (three 2D convs) is a TPU layout choice: here a 3x3x3
SubMConv3dDense is one cuDNN conv3d over the same parameters.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.epr.models.layers import (Conv, Dense, LayerNorm, mask3,
                                             update_running_stats)

BF16 = torch.bfloat16


class SubMConv3dDense(nn.Module):
    """Masked dense 3D conv == spconv SubMConv3d on the active set, bf16
    compute (reference models/modules.py:249-271)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, dtype=BF16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (kernel,) * 3,
                           padding=kernel // 2, dtype=dtype, xavier=True)

    def forward(self, x, mask):
        return mask3(self.Conv_0(mask3(x, mask)), mask)


class MaskedLayerNorm3d(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(c)

    def forward(self, x, mask):
        return mask3(self.LayerNorm_0(x), mask)


class MaskedBatchNorm3d(nn.Module):
    """BatchNorm over the active voxels of a dense volume (== BatchNorm1d
    over the sparse active set). f32 statistics, normalisation in the
    input's dtype, as in the JAX module; in training mode with batch
    statistics the running statistics (of the active voxels) follow the
    JAX module's update, momentum 0.9."""

    momentum = 0.9

    def __init__(self, c: int, use_running_average: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.ura, self.eps = use_running_average, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, mask):
        if self.ura:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.ndim - 1))
            x32 = x.float()
            w = mask.float()[..., None]
            n = w.sum().clamp(min=1.0)
            mean = (x32 * w).sum(dims) / n
            var = (w * (x32 - mean).square()).sum(dims) / n
            if self.training:
                update_running_stats(self, mean, var)
        dt = x.dtype
        y = ((x - mean.to(dt)) * torch.rsqrt(var + self.eps).to(dt)
             * self.weight.to(dt) + self.bias.to(dt))
        return mask3(y, mask)


class SubMConv3dBlockDense(nn.Module):
    """SubM conv + LayerNorm + ReLU (reference models/modules.py:440-452)."""

    def __init__(self, in_ch: int, features: int, kernel: int):
        super().__init__()
        self.SubMConv3dDense_0 = SubMConv3dDense(in_ch, features, kernel)
        self.LayerNorm_0 = LayerNorm(features)

    def forward(self, x, mask):
        x = self.LayerNorm_0(self.SubMConv3dDense_0(x, mask))
        return mask3(F.relu(x), mask)


class Sparse3dELANDense(nn.Module):
    """Sparse ELAN aggregation (reference models/modules.py:401-438)."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        half = dim // 2
        self.SubMConv3dBlockDense_0 = SubMConv3dBlockDense(in_ch, dim, 1)
        self.SubMConv3dBlockDense_1 = SubMConv3dBlockDense(in_ch, dim, 1)
        self.SubMConv3dBlockDense_2 = SubMConv3dBlockDense(dim, half, 3)
        self.SubMConv3dBlockDense_3 = SubMConv3dBlockDense(half, half, 3)
        self.SubMConv3dBlockDense_4 = SubMConv3dBlockDense(half, half, 3)
        self.SubMConv3dBlockDense_5 = SubMConv3dBlockDense(half, half, 3)
        self.SubMConv3dBlockDense_6 = SubMConv3dBlockDense(4 * dim, dim, 1)

    def forward(self, x, mask):
        f2 = self.SubMConv3dBlockDense_1(x, mask)
        parts = [self.SubMConv3dBlockDense_0(x, mask), f2]
        for blk in (self.SubMConv3dBlockDense_2, self.SubMConv3dBlockDense_3,
                    self.SubMConv3dBlockDense_4, self.SubMConv3dBlockDense_5):
            f2 = blk(f2, mask)
            parts.append(f2)
        return self.SubMConv3dBlockDense_6(torch.cat(parts, dim=-1), mask)


def _box_count(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Count of True cells in each kxkxk window (zero padding)."""
    w = torch.ones(1, 1, k, k, k, device=mask.device)
    return F.conv3d(mask.float()[None, None], w, padding=k // 2)[0, 0]


def erode(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Binary erosion (reference models/neucon_network.py:216-221)."""
    return _box_count(mask, kernel_size) == float(kernel_size ** 3)


def dilate(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Binary dilation (reference models/neucon_network.py:223-228)."""
    return _box_count(mask, kernel_size) >= 1.0


def maxpool3d(vol: torch.Tensor, factor: int) -> torch.Tensor:
    """Max-pool an [X, Y, Z] volume (bool or float) by an integer factor."""
    x, y, z = vol.shape
    v = vol.reshape(x // factor, factor, y // factor, factor, z // factor,
                    factor)
    if v.dtype == torch.bool:
        return v.any(5).any(3).any(1)
    return v.amax(dim=(1, 3, 5))


def upsample_nearest2(vol: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z, C] -> [2X, 2Y, 2Z, C] nearest (sparse x8 upsample)."""
    x, y, z, c = vol.shape
    v = vol[:, None, :, None, :, None, :].expand(x, 2, y, 2, z, 2, c)
    return v.reshape(2 * x, 2 * y, 2 * z, c)


def upsample_trilinear(vol: torch.Tensor, factor: int) -> torch.Tensor:
    """[X, Y, Z, C] corner-aligned trilinear upsample == torchsparse
    devoxelize: fine voxel c mixes coarse corners floor(c/f) and +1 with
    weights (1 - frac, frac); corners past the top edge contribute zero."""
    for axis in range(3):
        n = vol.shape[axis]
        pad = [0, 0] * (vol.ndim - 1 - axis) + [0, 1]
        nxt = F.pad(vol, pad).narrow(axis, 1, n)
        a = vol.repeat_interleave(factor, dim=axis)
        b = nxt.repeat_interleave(factor, dim=axis)
        frac = (torch.arange(n * factor, device=vol.device) % factor) / factor
        shape = [1] * vol.ndim
        shape[axis] = n * factor
        frac = frac.reshape(shape).to(vol.dtype)
        vol = a * (1 - frac) + b * frac
    return vol


class ConvDown3dDense(nn.Module):
    """ks=2 stride-2 conv; output mask = any-active in each 2^3 cell."""

    def __init__(self, in_ch: int, features: int, dtype=BF16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (2, 2, 2), stride=2, bias=False,
                           dtype=dtype)

    def forward(self, x, mask):
        y = self.Conv_0(mask3(x, mask))
        out_mask = maxpool3d(mask, 2)
        return mask3(y, out_mask), out_mask


class ConvUp3dDense(nn.Module):
    """ks=2 stride-2 transposed conv; outputs restricted to the fine mask."""

    def __init__(self, in_ch: int, features: int, dtype=BF16):
        super().__init__()
        self.ConvTranspose_0 = Conv(in_ch, features, (2, 2, 2), stride=2,
                                    bias=False, dtype=dtype, transpose=True)

    def forward(self, x, coarse_mask, fine_mask):
        return mask3(self.ConvTranspose_0(mask3(x, coarse_mask)), fine_mask)


class DenseResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + (1x1-BN skip) + ReLU
    (reference models/modules.py:46-72)."""

    def __init__(self, in_ch: int, features: int,
                 use_running_average: bool = False):
        super().__init__()
        ura = use_running_average
        self.SubMConv3dDense_0 = SubMConv3dDense(in_ch, features)
        self.MaskedBatchNorm3d_0 = MaskedBatchNorm3d(features, ura)
        self.SubMConv3dDense_1 = SubMConv3dDense(features, features)
        self.MaskedBatchNorm3d_1 = MaskedBatchNorm3d(features, ura)
        self.project = in_ch != features
        if self.project:
            self.Dense_0 = Dense(in_ch, features, bias=False)
            self.MaskedBatchNorm3d_2 = MaskedBatchNorm3d(features, ura)

    def forward(self, x, mask):
        h = self.SubMConv3dDense_0(x, mask)
        h = F.relu(self.MaskedBatchNorm3d_0(h, mask))
        h = self.SubMConv3dDense_1(h, mask)
        h = self.MaskedBatchNorm3d_1(h, mask)
        skip = (self.MaskedBatchNorm3d_2(self.Dense_0(x), mask)
                if self.project else x)
        return mask3(F.relu(h + skip), mask)
