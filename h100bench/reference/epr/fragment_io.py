"""The containers of the fragment program's call convention
(`inference/pipeline.fragment_forward`, and its exported artifact):
`(imgs, FragmentInputs, RecurrentState, PanopticGlobalDense) -> (outputs,
losses, RecurrentState, PanopticGlobalDense)`.

They live outside `models/` so that a serving process can load an
exported program without the model code. Importing this module registers
them with torch's pytree under stable names (`h100bench.reference.epr.<class>`),
the counterpart of eprecon_tpu/inference/export.py:38-54: torch.export
serialises a call convention only with named nodes, and needs the same
names registered where the artifact is loaded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch


class FragmentInputs(NamedTuple):
    """One fragment's geometry (batch=1). rel_origins are the window
    origins per stage in level units, relative to the global volume: an
    int tensor on the model's device, read as data by the window slicing
    (`models/gru_fusion.window_index`), so an exported program takes the
    position as an input."""
    proj_matrices: torch.Tensor           # [V, n_scales, 4, 4] world->pixel
    vol_origin_partial: torch.Tensor      # [3] fragment world origin
    world_to_aligned_camera: torch.Tensor  # [4, 4]
    rel_origins: torch.Tensor             # [n_stages, 3] int


class RecurrentState(NamedTuple):
    """Cross-fragment state of one scene stream; reset at scene change."""
    gmaps: Tuple[DenseGlobalLevel, ...]  # per stage (0 = coarse)
    tmaps: Tuple[DenseTargetLevel, ...]  # GT tsdf target volumes per stage


@dataclass
class DenseGlobalLevel:
    """Dense global feature volume at one pyramid level."""
    feats: torch.Tensor  # [Gx, Gy, Gz, C]
    mask: torch.Tensor   # [Gx, Gy, Gz] bool

    @staticmethod
    def empty(extent: Tuple[int, int, int], channels: int,
              dtype=torch.float32, device=None) -> "DenseGlobalLevel":
        return DenseGlobalLevel(
            torch.zeros(*extent, channels, dtype=dtype, device=device),
            torch.zeros(*extent, dtype=torch.bool, device=device))


@dataclass
class DenseTargetLevel:
    """Dense global GT-TSDF volume at one pyramid level (reference
    target_tsdf_volume)."""
    tsdf: torch.Tensor  # [Gx, Gy, Gz] f32 (init 1)
    occ: torch.Tensor   # [Gx, Gy, Gz] bool

    @staticmethod
    def empty(extent: Tuple[int, int, int], device=None) -> "DenseTargetLevel":
        return DenseTargetLevel(torch.ones(extent, device=device),
                                torch.zeros(extent, dtype=torch.bool,
                                            device=device))


@dataclass
class PanopticGlobalDense:
    tsdf: torch.Tensor      # [Gx, Gy, Gz] f32 (init 1)
    instance: torch.Tensor  # [Gx, Gy, Gz] int32
    semantic: torch.Tensor  # [Gx, Gy, Gz] int32
    mask: torch.Tensor      # [Gx, Gy, Gz] bool (observed near-surface)
    next_instance_id: torch.Tensor  # int32 scalar

    @staticmethod
    def empty(extent: Tuple[int, int, int], max_stuff: int = 2,
              device=None) -> "PanopticGlobalDense":
        i32 = torch.int32
        return PanopticGlobalDense(
            torch.ones(extent, device=device),
            torch.zeros(extent, dtype=i32, device=device),
            torch.zeros(extent, dtype=i32, device=device),
            torch.zeros(extent, dtype=torch.bool, device=device),
            torch.tensor(max_stuff, dtype=i32, device=device))
