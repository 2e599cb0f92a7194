"""Voxel grid coordinate helpers (port of eprecon_tpu/ops/grid.py;
reference: ops/generate_grids.py:3-10, utils.py:138-153)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def generate_grid(n_vox: Sequence[int], interval: int, device=None
                  ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """Every `interval`-th voxel coordinate of an n_vox grid: (coords
    [3, N] f32 in 'ij' meshgrid order, the grid's shape) (reference
    ops/generate_grids.py:3-10)."""
    axes = [torch.arange(0, n, interval, dtype=torch.float32, device=device)
            for n in n_vox]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))
    return grid.reshape(3, -1), tuple(len(a) for a in axes)


def coordinates(voxel_dim: Sequence[int], device=None) -> torch.Tensor:
    """Dense integer coordinates [3, nx*ny*nz] int32, 'ij' order
    (reference utils.py:138-153)."""
    return dense_coords(voxel_dim, device).reshape(-1, 3).T


def dense_coords(shape: Sequence[int], device=None) -> torch.Tensor:
    """Dense integer coordinates [nx, ny, nz, 3] (int32, 'ij' order)."""
    axes = [torch.arange(n, dtype=torch.int32, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def scene_global_origin(global_extent: Sequence[int], n_vox: Sequence[int],
                        n_scales: int, voxel_size: float,
                        vol_origin: np.ndarray,
                        desired_margin: int = 32) -> np.ndarray:
    """World origin of a scene's dense global volume.

    A margin below the scene origin, capped per axis at half the slack the
    volume has (extent - window) so the window clamp never relocates a
    fragment, and floored to the coarsest-level grid so every pyramid
    level's relative origin is integral.
    """
    snap_units = 2 ** n_scales
    slack = np.maximum(np.asarray(global_extent) - np.asarray(n_vox), 0)
    margin_units = np.minimum(desired_margin, slack // 2)
    margin_units = margin_units // snap_units * snap_units
    origin = np.asarray(vol_origin, np.float32) - margin_units * voxel_size
    snap = voxel_size * snap_units
    return (np.floor(origin / snap + 1e-4) * snap).astype(np.float32)


def anchored_global_origin(anchor: np.ndarray, n_scales: int,
                           voxel_size: float, margin: int) -> np.ndarray:
    """World origin of a scene's dense global volume from a window-union
    anchor (already snapped to the coarsest window grid in its own frame):
    subtract a margin snapped to 2**n_scales voxels."""
    snap_units = 2 ** n_scales
    margin_units = int(margin) // snap_units * snap_units
    return (np.asarray(anchor, np.float32)
            - np.float32(margin_units * voxel_size))
