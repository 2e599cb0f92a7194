"""Shared building blocks, channels-last (port of eprecon_tpu/models/blocks.py;
reference: models/modules.py:273-482).

Submodule attribute names are flax's auto-names (`Conv_0`, `BatchNorm_0`,
...) so convert.py maps a flax tree onto them one to one.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from eprecon_tpu_torch.models.layers import (BatchNorm, Conv, Dense, LayerNorm,
                                             update_running_stats)

BF16 = torch.bfloat16


class Conv2dBlock(nn.Module):
    """Conv + BN + ReLU (reference models/modules.py:372-382), bf16."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 use_running_average: bool = False, dtype=BF16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (kernel, kernel),
                           padding=kernel // 2, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, use_running_average, dtype=dtype)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Conv2dResidualBlock(nn.Module):
    """Conv + ReLU + residual + BN (reference models/modules.py:385-399)."""

    def __init__(self, ch: int, kernel: int, use_running_average: bool = False,
                 dtype=BF16):
        super().__init__()
        self.Conv_0 = Conv(ch, ch, (kernel, kernel), padding=kernel // 2,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(ch, use_running_average, dtype=dtype)

    def forward(self, x):
        return self.BatchNorm_0(F.relu(self.Conv_0(x)) + x)


class ELAN2D(nn.Module):
    """ELAN aggregation (reference models/modules.py:340-370)."""

    def __init__(self, in_ch: int, dim: int, use_running_average: bool = False):
        super().__init__()
        ura, half = use_running_average, dim // 2
        self.Conv2dBlock_0 = Conv2dBlock(in_ch, dim, 1, ura)
        self.Conv2dBlock_1 = Conv2dBlock(in_ch, dim, 1, ura)
        self.Conv2dBlock_2 = Conv2dBlock(dim, half, 3, ura)
        self.Conv2dBlock_3 = Conv2dBlock(half, half, 3, ura)
        self.Conv2dBlock_4 = Conv2dBlock(half, half, 3, ura)
        self.Conv2dBlock_5 = Conv2dBlock(half, half, 3, ura)
        self.Conv2dBlock_6 = Conv2dBlock(2 * dim + 4 * half, dim, 1, ura)

    def forward(self, x):
        f = self.Conv2dBlock_0(x)
        f2 = self.Conv2dBlock_1(x)
        parts = [f, f2]
        for blk in (self.Conv2dBlock_2, self.Conv2dBlock_3,
                    self.Conv2dBlock_4, self.Conv2dBlock_5):
            f2 = blk(f2)
            parts.append(f2)
        return self.Conv2dBlock_6(torch.cat(parts, dim=-1))


class FusionBlock(nn.Module):
    """conv3+BN+ReLU -> conv1+BN+ReLU -> ELAN (reference models/modules.py:313-338)."""

    def __init__(self, c: int, use_running_average: bool = False):
        super().__init__()
        ura = use_running_average
        self.Conv_0 = Conv(c, c, (3, 3), padding=1, dtype=BF16)
        self.BatchNorm_0 = BatchNorm(c, ura, dtype=BF16)
        self.Conv_1 = Conv(c, c, (1, 1), dtype=BF16)
        self.BatchNorm_1 = BatchNorm(c, ura, dtype=BF16)
        self.ELAN2D_0 = ELAN2D(c, c, ura)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        return self.ELAN2D_0(out)


class Linear4xTrans(nn.Module):
    """4x bottleneck MLP head with LN and a residual when widths match
    (reference models/modules.py:273-311). dtype=bf16 at the panoptic
    transfer heads; None keeps the tsdf/occ heads in f32."""

    def __init__(self, c_in: int, features_out: int, dtype=None):
        super().__init__()
        self.residual = c_in == features_out
        self.Dense_0 = Dense(c_in, 4 * c_in, dtype=dtype, xavier=True)
        self.LayerNorm_0 = LayerNorm(4 * c_in, dtype=dtype)
        self.Dense_1 = Dense(4 * c_in, c_in, dtype=dtype, xavier=True)
        self.LayerNorm_1 = LayerNorm(c_in, dtype=dtype)
        self.Dense_2 = Dense(c_in, features_out, dtype=dtype, xavier=True)

    def forward(self, x):
        out = F.relu(self.LayerNorm_0(self.Dense_0(x)))
        out = F.relu(self.LayerNorm_1(self.Dense_1(out)))
        out2 = self.Dense_2(out)
        return out2 + out if self.residual else out2


class LinearResidual(nn.Module):
    """Dense + ReLU + residual + LayerNorm, in f32 (reference
    models/modules.py:454-467)."""

    def __init__(self, c: int):
        super().__init__()
        self.Dense_0 = Dense(c, c)
        self.LayerNorm_0 = LayerNorm(c)

    def forward(self, x):
        return self.LayerNorm_0(x + F.relu(self.Dense_0(x)))


class MLP(nn.Module):
    """Plain ReLU MLP (reference models/mask3dformer.py:187-199)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            setattr(self, f"Dense_{i}", Dense(dims[i], dims[i + 1]))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a [K, C] sparse feature set
    (port of eprecon_tpu/models/blocks.py:138-169; reference BatchNorm1d
    on the active voxels). Batch statistics unless `use_running_average`;
    in training mode with batch statistics the running statistics follow
    the JAX module's update, momentum 0.9. Arithmetic in the input's dtype,
    as the JAX module's."""

    momentum = 0.9

    def __init__(self, c: int, use_running_average: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.ura, self.eps = use_running_average, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.ura:
            mean, var = self.running_mean, self.running_var
        else:
            w = valid.to(x.dtype)[:, None]
            n = w.sum().clamp(min=1.0)
            mean = (x * w).sum(0) / n
            var = (w * (x - mean).square()).sum(0) / n
            if self.training:
                update_running_stats(self, mean, var)
        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return torch.where(valid[:, None], y, 0.0)
