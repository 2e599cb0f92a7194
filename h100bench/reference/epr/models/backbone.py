"""MNASNet-1.0 trunk + FPN backbone, NHWC (port of
eprecon_tpu/models/backbone.py; reference models/backbone.py:22-77).

For alpha=1 and input [N, 480, 640, 3] returns
[[N,120,160,24], [N,60,80,40], [N,30,40,80]] (fine -> coarse), bf16.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference.epr.models.layers import BatchNorm, Conv

BF16 = torch.bfloat16


def _round_to_multiple_of(val: float, divisor: int,
                          round_up_bias: float = 0.9) -> int:
    new_val = max(divisor, int(val + divisor / 2) // divisor * divisor)
    return new_val if new_val >= round_up_bias * val else new_val + divisor


def get_depths(alpha: float) -> List[int]:
    depths = [32, 16, 24, 40, 80, 96, 192, 320]
    return [_round_to_multiple_of(d * alpha, 8) for d in depths]


class InvertedResidual(nn.Module):
    """MNASNet MBConv block: 1x1 expand -> kxk depthwise -> 1x1 project."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expansion: int, use_running_average: bool = False):
        super().__init__()
        mid = in_ch * expansion
        ura = use_running_average
        self.residual = stride == 1 and in_ch == out_ch
        self.Conv_0 = Conv(in_ch, mid, (1, 1), bias=False, dtype=BF16)
        self.BatchNorm_0 = BatchNorm(mid, ura, dtype=BF16)
        self.Conv_1 = Conv(mid, mid, (kernel, kernel), stride=stride,
                           padding=kernel // 2, groups=mid, bias=False,
                           dtype=BF16)
        self.BatchNorm_1 = BatchNorm(mid, ura, dtype=BF16)
        self.Conv_2 = Conv(mid, out_ch, (1, 1), bias=False, dtype=BF16)
        self.BatchNorm_2 = BatchNorm(out_ch, ura, dtype=BF16)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        return h + x if self.residual else h


class MBStack(nn.Sequential):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expansion: int, repeats: int,
                 use_running_average: bool = False):
        super().__init__()
        ura = use_running_average
        self.add_module("InvertedResidual_0", InvertedResidual(
            in_ch, out_ch, kernel, stride, expansion, ura))
        for i in range(1, repeats):
            self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                out_ch, out_ch, kernel, 1, expansion, ura))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of NHWC (jax.image.resize 'nearest' at x2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MnasMulti(nn.Module):
    """3-scale FPN over an MNASNet trunk. Input NHWC, output fine -> coarse."""

    def __init__(self, alpha: float = 1.0, use_running_average: bool = False):
        super().__init__()
        d = get_depths(alpha)
        ura = use_running_average
        self.Conv_0 = Conv(3, d[0], (3, 3), stride=2, padding=1, bias=False,
                           dtype=BF16)
        self.BatchNorm_0 = BatchNorm(d[0], ura, dtype=BF16)
        self.Conv_1 = Conv(d[0], d[0], (3, 3), padding=1, groups=d[0],
                           bias=False, dtype=BF16)
        self.BatchNorm_1 = BatchNorm(d[0], ura, dtype=BF16)
        self.Conv_2 = Conv(d[0], d[1], (1, 1), bias=False, dtype=BF16)
        self.BatchNorm_2 = BatchNorm(d[1], ura, dtype=BF16)
        self.MBStack_0 = MBStack(d[1], d[2], 3, 2, 3, 3, ura)   # 1/4, 24ch
        self.MBStack_1 = MBStack(d[2], d[3], 5, 2, 3, 3, ura)   # 1/8, 40ch
        self.MBStack_2 = MBStack(d[3], d[4], 5, 2, 6, 3, ura)   # 1/16, 80ch
        # FPN (reference backbone.py:47-77)
        self.Conv_3 = Conv(d[4], d[4], (1, 1), bias=False, dtype=BF16)
        self.Conv_4 = Conv(d[3], d[4], (1, 1), dtype=BF16)
        self.Conv_5 = Conv(d[4], d[3], (3, 3), padding=1, bias=False,
                           dtype=BF16)
        self.Conv_6 = Conv(d[2], d[4], (1, 1), dtype=BF16)
        self.Conv_7 = Conv(d[4], d[2], (3, 3), padding=1, bias=False,
                           dtype=BF16)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        conv0 = self.MBStack_0(h)
        conv1 = self.MBStack_1(conv0)
        conv2 = self.MBStack_2(conv1)

        out_coarse = self.Conv_3(conv2)
        intra = _up2(conv2) + self.Conv_4(conv1)
        out_mid = self.Conv_5(intra)
        intra = _up2(intra) + self.Conv_6(conv0)
        out_fine = self.Conv_7(intra)
        return [out_fine, out_mid, out_coarse]
