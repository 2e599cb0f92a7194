"""Fourier positional encoding for voxel coordinates (port of
eprecon_tpu/models/panoptic/position_encoding.py; reference
models/voxel_position_encoding.py:42-175, fourier branch, normalize=True)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


class FourierPositionEncoding(nn.Module):
    """xyz [N, 3] -> [N, d_pos] fourier features. The gaussian projection
    is a fixed buffer: random here (seeded by the caller's generator);
    convert.py loads the JAX package's from its 'buffers' collection."""

    def __init__(self, d_pos: int, gauss_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.register_buffer("gauss_B", torch.randn(
            3, d_pos // 2, generator=generator) * gauss_scale)

    def forward(self, xyz, src_min, src_max):
        p = (xyz - src_min) / (src_max - src_min) * (2.0 * math.pi)
        proj = p @ self.gauss_B
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
