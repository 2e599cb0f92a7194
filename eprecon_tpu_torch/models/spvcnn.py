"""SPVCNN sparse 3D U-Net, SConv3d and ConvGRU on the sparse voxel engine
(port of eprecon_tpu/models/spvcnn.py; reference models/modules.py:75-222
and the torchsparse glue of ops/torchsparse_utils.py:15-106).

Points live in the gravity-aligned camera frame (float coords, metres).
Every index structure (voxelisation, neighbour maps, parent maps,
trilinear links) is built once per point set into a `SparsePlan` that all
the conv layers share, as torchsparse caches its kernel maps; a conv is a
per-offset gather and matmuls (`ops/sparse.sparse_conv_apply`).

A research engine, off the serving path as in the JAX package: the model
(`models/eprecon.py`) runs the masked dense-window U-Net
(`models/unet_dense.py`). It is the oracle of torchsparse's semantics and
the starting point should a scene outgrow the dense global volume.

The modules are made on CUDA unless `device="cpu"` (and raise without
CUDA), as every entry point of the port; `build_plan` works on the
device of its points. Submodules carry flax's names (`stem`, `DownBNReLU_0`,
`SparseResidualBlock_3`, `Dense_0`, ...) and the sparse convs keep flax's
[O, Cin, Cout] kernel, so `convert.variables_to_torch` loads a flax tree
as it is. Modules take their input channels at construction (flax infers
them).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eprecon_tpu_torch.device import DeviceLike, resolve_device
from eprecon_tpu_torch.models.blocks import MaskedBatchNorm
from eprecon_tpu_torch.models.layers import Dense
from eprecon_tpu_torch.ops import sparse as sp

OFFSETS27 = sp.kernel_offsets(3)
OFFSETS8 = sp.kernel_offsets(2)
DEFAULT_WINDOW = 192  # static L0 index-table span (aligned-camera voxel units)


class LevelPlan(NamedTuple):
    grid: sp.HashedGrid                   # the voxel set, coords in level units
    nmap27: torch.Tensor                  # [K, 27] same-level neighbour rows
    down_nmap8: Optional[torch.Tensor]    # [K, 8] finer-level rows feeding this
                                          # level's stride-2 conv (None at L0)
    parent_of_fine: Optional[torch.Tensor]  # [K] row here of each finer voxel
    fine_mod2: Optional[torch.Tensor]     # [K] offset index (0..7) of each
                                          # finer voxel in its parent


class SparsePlan(NamedTuple):
    levels: Tuple[LevelPlan, ...]         # L0 (fine) -> L2 (coarse)
    devox_idx: Tuple[torch.Tensor, ...]   # per level: corner rows [K, 8]
    devox_w: Tuple[torch.Tensor, ...]     # per level: trilinear weights [K, 8]
    point_to_l0: torch.Tensor             # [K] row of each point in L0
    valid_points: torch.Tensor            # [K] bool


def _level_window(w0: int, level: int) -> Tuple[int, int, int]:
    w = (w0 >> level) + 2
    return (w, w, w)


def build_plan(points: sp.PointSet, vres: float, num_levels: int = 3,
               window: int = DEFAULT_WINDOW) -> SparsePlan:
    """Every index structure of a `num_levels` U-Net over `points` at voxel
    size `vres`. `window` is the static span of the L0 index table and must
    cover the quantised cloud's extent (its min corner is data)."""
    grid0, idx_q = sp.voxelize(points, vres, _level_window(window, 0))
    grids: List[sp.HashedGrid] = [grid0]
    down_maps, parents, mods = [None], [None], [None]
    offsets8 = torch.as_tensor(OFFSETS8, device=points.xyz.device).long()
    prev = grid0
    for level in range(1, num_levels):
        coarse, parent = sp.downsample_coords(prev.voxels,
                                              _level_window(window, level))
        # stride-2 conv inputs: for coarse coord p, the fine rows at 2p + r
        q = coarse.voxels.coords.long()
        nb = q[:, None, 1:] * 2 + offsets8[None]
        bcol = q[:, None, :1].expand(*nb.shape[:2], 1)
        down8 = sp.lookup(prev, torch.cat([bcol, nb], dim=-1),
                          coarse.voxels.valid)
        # transposed-conv links: fine voxel c -> parent row, slot c mod 2
        fc = prev.voxels.coords.long()
        mod = torch.where(prev.voxels.valid,
                          (fc[:, 1] & 1) * 4 + (fc[:, 2] & 1) * 2 + (fc[:, 3] & 1),
                          0)
        grids.append(coarse)
        down_maps.append(down8)
        parents.append(parent)
        mods.append(mod)
        prev = coarse

    levels, devox_idx, devox_w = [], [], []
    for level, g in enumerate(grids):
        nmap27 = sp.neighbor_map(g, g.voxels.coords, g.voxels.valid, OFFSETS27)
        levels.append(LevelPlan(g, nmap27, down_maps[level], parents[level],
                                mods[level]))
        di, dw = sp.trilinear_links(g, points, vres * 2 ** level)
        devox_idx.append(di)
        devox_w.append(dw)
    return SparsePlan(tuple(levels), tuple(devox_idx), tuple(devox_w), idx_q,
                      points.valid)


def init_sparse_module(module: nn.Module, seed: int,
                       device: DeviceLike = None) -> nn.Module:
    """Random weights from `seed` for every sparse kernel (He-uniform) and
    Dense (flax's lecun-normal) under `module`, then the module on
    `device`: CUDA unless "cpu", as the port's entry points. Load trained
    or JAX-made weights with convert.variables_to_torch."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (_SparseKernel, Dense)):
            m.reset_parameters(gen)
    return module.to(resolve_device(device))


def devoxelize(plan: SparsePlan, level: int,
               voxel_feats: torch.Tensor) -> torch.Tensor:
    """Trilinear voxel -> point (torchsparse voxel_to_point, nearest=False)."""
    return torch.einsum("ko,koc->kc", plan.devox_w[level],
                        sp.gather_rows(voxel_feats, plan.devox_idx[level]))


def avg_to_voxels(plan: SparsePlan, level: int,
                  point_feats: torch.Tensor) -> torch.Tensor:
    """Average point features into the voxels of `level` (torchsparse
    point_to_voxel): each point joins its containing cell, found at level
    > 0 through the parent chain."""
    idx = plan.point_to_l0
    for lv in range(1, level + 1):
        idx = torch.where(idx >= 0,
                          plan.levels[lv].parent_of_fine[idx.clamp(min=0)], -1)
    k = plan.levels[level].grid.voxels.capacity
    member = (idx >= 0) & plan.valid_points
    out = sp.segment_mean(point_feats, torch.where(member, idx, k), member, k)
    return torch.where(plan.levels[level].grid.voxels.valid[:, None], out, 0.0)


class _SparseKernel(nn.Module):
    """A sparse conv's kernel [O, Cin, Cout] in flax's layout (convert.py
    copies it as it is); `reset_parameters` draws it He-uniform over
    fan_in = O * Cin, as torchsparse's Conv3d initialises it."""

    flax_kernel_layout = True

    def __init__(self, n_offsets: int, in_ch: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_offsets, in_ch, features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = math.sqrt(1.0 / (self.weight.shape[0] * self.weight.shape[1]))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)


class SpConv(_SparseKernel):
    """Same-level sparse conv (ks=3, stride 1; coordinate-preserving)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(27, in_ch, features)

    def forward(self, feats, plan: SparsePlan, level: int):
        lp = plan.levels[level]
        return sp.sparse_conv_apply(feats, lp.nmap27, self.weight,
                                    out_valid=lp.grid.voxels.valid)


class SpConvDown(_SparseKernel):
    """Stride-2 downsampling conv (ks=2): fine level l -> coarse l + 1."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(8, in_ch, features)

    def forward(self, fine_feats, plan: SparsePlan, coarse_level: int):
        lp = plan.levels[coarse_level]
        return sp.sparse_conv_apply(fine_feats, lp.down_nmap8, self.weight,
                                    out_valid=lp.grid.voxels.valid)


class SpConvUp(_SparseKernel):
    """Transposed stride-2 conv (ks=2): coarse level l -> fine l - 1. Each
    fine voxel c has one source, its parent floor(c / 2), through kernel
    slot c mod 2 (torchsparse's transposed kernel map, inverted)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(8, in_ch, features)

    def forward(self, coarse_feats, plan: SparsePlan, coarse_level: int):
        lp = plan.levels[coarse_level]
        fine = plan.levels[coarse_level - 1]
        src = sp.gather_rows(coarse_feats, lp.parent_of_fine)      # [Kf, Cin]
        outs = torch.stack([src @ self.weight[r] for r in range(8)], dim=1)
        out = outs.gather(1, lp.fine_mod2[:, None, None].expand(
            -1, 1, outs.shape[-1]))[:, 0]
        return torch.where(fine.grid.voxels.valid[:, None], out, 0.0)


class _ConvBNReLU(nn.Module):
    conv = None       # the conv class
    bn_level = 0      # the BN's level relative to the conv's level argument

    def __init__(self, in_ch: int, features: int,
                 use_running_average: bool = False):
        super().__init__()
        setattr(self, f"{self.conv.__name__}_0", self.conv(in_ch, features))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, use_running_average)

    def forward(self, feats, plan: SparsePlan, level: int):
        h = getattr(self, f"{self.conv.__name__}_0")(feats, plan, level)
        valid = plan.levels[level + self.bn_level].grid.voxels.valid
        return F.relu(self.MaskedBatchNorm_0(h, valid))


class ConvBNReLU(_ConvBNReLU):
    conv = SpConv


class DownBNReLU(_ConvBNReLU):
    conv = SpConvDown


class UpBNReLU(_ConvBNReLU):
    conv = SpConvUp
    bn_level = -1


class SparseResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + (1x1-BN projection where the width changes)
    + ReLU (reference models/modules.py:46-72)."""

    def __init__(self, in_ch: int, features: int,
                 use_running_average: bool = False):
        super().__init__()
        ura = use_running_average
        self.SpConv_0 = SpConv(in_ch, features)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, ura)
        self.SpConv_1 = SpConv(features, features)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, ura)
        self.project = in_ch != features
        if self.project:
            self.Dense_0 = Dense(in_ch, features, bias=False)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(features, ura)

    def forward(self, feats, plan: SparsePlan, level: int):
        valid = plan.levels[level].grid.voxels.valid
        h = F.relu(self.MaskedBatchNorm_0(self.SpConv_0(feats, plan, level),
                                          valid))
        h = self.MaskedBatchNorm_1(self.SpConv_1(h, plan, level), valid)
        skip = (self.MaskedBatchNorm_2(self.Dense_0(feats), valid)
                if self.project else feats)
        return F.relu(h + skip)


DROPOUT = 0.3


class SPVCNN(nn.Module):
    """Sparse point-voxel U-Net (reference models/modules.py:75-175):
    channels cs = [32, 64, 128, 96, 96] * cr; point features [K, in_ch]
    with a prebuilt SparsePlan in, per-point features [K, cs[4]] out.

    With `dropout`, a training forward drops 30% of the coarsest voxel
    features, as the JAX module's nn.Dropout, from the caller's
    `generator` (the JAX module draws from its 'dropout' RNG stream: the
    two streams differ)."""

    def __init__(self, in_ch: int, cr: float = 1.0, dropout: bool = False,
                 use_running_average: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cs = [int(cr * x) for x in (32, 64, 128, 96, 96)]
        ura = use_running_average
        self.dropout = dropout
        self.stem = ConvBNReLU(in_ch, cs[0], ura)
        self.DownBNReLU_0 = DownBNReLU(cs[0], cs[0], ura)
        self.SparseResidualBlock_0 = SparseResidualBlock(cs[0], cs[1], ura)
        self.SparseResidualBlock_1 = SparseResidualBlock(cs[1], cs[1], ura)
        self.DownBNReLU_1 = DownBNReLU(cs[1], cs[1], ura)
        self.SparseResidualBlock_2 = SparseResidualBlock(cs[1], cs[2], ura)
        self.SparseResidualBlock_3 = SparseResidualBlock(cs[2], cs[2], ura)
        self.Dense_0 = Dense(cs[0], cs[2])
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cs[2], ura)
        self.UpBNReLU_0 = UpBNReLU(cs[2], cs[3], ura)
        self.SparseResidualBlock_4 = SparseResidualBlock(cs[3] + cs[1], cs[3], ura)
        self.SparseResidualBlock_5 = SparseResidualBlock(cs[3], cs[3], ura)
        self.UpBNReLU_1 = UpBNReLU(cs[3], cs[4], ura)
        self.SparseResidualBlock_6 = SparseResidualBlock(cs[4] + cs[0], cs[4], ura)
        self.SparseResidualBlock_7 = SparseResidualBlock(cs[4], cs[4], ura)
        self.Dense_1 = Dense(cs[2], cs[4])
        self.MaskedBatchNorm_1 = MaskedBatchNorm(cs[4], ura)
        init_sparse_module(self, seed, device)

    def forward(self, point_feats, plan: SparsePlan, train: bool = True,
                generator: Optional[torch.Generator] = None):
        # stem at L0
        x0 = self.stem(avg_to_voxels(plan, 0, point_feats), plan, 0)
        z0 = devoxelize(plan, 0, x0)

        # down path
        x1 = self.DownBNReLU_0(avg_to_voxels(plan, 0, z0), plan, 1)
        x1 = self.SparseResidualBlock_0(x1, plan, 1)
        x1 = self.SparseResidualBlock_1(x1, plan, 1)
        x2 = self.DownBNReLU_1(x1, plan, 2)
        x2 = self.SparseResidualBlock_2(x2, plan, 2)
        x2 = self.SparseResidualBlock_3(x2, plan, 2)

        z1 = devoxelize(plan, 2, x2)
        pt0 = self.MaskedBatchNorm_0(self.Dense_0(z0), plan.valid_points)
        z1 = z1 + F.relu(pt0)

        # up path
        y3 = avg_to_voxels(plan, 2, z1)
        if self.dropout and train:
            if generator is None:
                raise ValueError("SPVCNN(dropout=True) trains with an explicit "
                                 "torch.Generator for its dropout")
            keep = torch.rand(y3.shape, generator=generator,
                              device=y3.device) < 1.0 - DROPOUT
            y3 = torch.where(keep, y3 / (1.0 - DROPOUT), 0.0)
        y3 = self.UpBNReLU_0(y3, plan, 2)
        y3 = self.SparseResidualBlock_4(torch.cat([y3, x1], dim=-1), plan, 1)
        y3 = self.SparseResidualBlock_5(y3, plan, 1)

        y4 = self.UpBNReLU_1(y3, plan, 1)
        y4 = self.SparseResidualBlock_6(torch.cat([y4, x0], dim=-1), plan, 0)
        y4 = self.SparseResidualBlock_7(y4, plan, 0)

        z3 = devoxelize(plan, 0, y4)
        pt1 = self.MaskedBatchNorm_1(self.Dense_1(z1), plan.valid_points)
        z3 = z3 + F.relu(pt1)
        return torch.where(plan.valid_points[:, None], z3, 0.0)


class SConv3dPlan(NamedTuple):
    """Prebuilt index plan of SConv3d / ConvGRU over one point set."""
    grid: sp.HashedGrid
    nmap27: torch.Tensor
    idx_query: torch.Tensor
    devox_idx: torch.Tensor
    devox_w: torch.Tensor
    valid_points: torch.Tensor


def build_sconv_plan(points: sp.PointSet, vres: float,
                     window: int = DEFAULT_WINDOW) -> SConv3dPlan:
    grid, idx_q = sp.voxelize(points, vres, (window, window, window))
    nmap = sp.neighbor_map(grid, grid.voxels.coords, grid.voxels.valid,
                           OFFSETS27)
    di, dw = sp.trilinear_links(grid, points, vres)
    return SConv3dPlan(grid, nmap, idx_q, di, dw, points.valid)


class SConv3d(_SparseKernel):
    """voxelize -> ks3 conv -> trilinear devoxelize, plus a linear point
    residual (reference models/modules.py:178-197)."""

    def __init__(self, in_ch: int, features: int, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(27, in_ch, features)
        self.Dense_0 = Dense(in_ch, features)
        init_sparse_module(self, seed, device)

    def forward(self, point_feats, plan: SConv3dPlan):
        k = plan.grid.voxels.capacity
        member = (plan.idx_query >= 0) & plan.valid_points
        vox = sp.segment_mean(point_feats,
                              torch.where(member, plan.idx_query, k), member, k)
        vox = torch.where(plan.grid.voxels.valid[:, None], vox, 0.0)
        vox = sp.sparse_conv_apply(vox, plan.nmap27, self.weight,
                                   out_valid=plan.grid.voxels.valid)
        out = torch.einsum("ko,koc->kc", plan.devox_w,
                           sp.gather_rows(vox, plan.devox_idx))
        out = out + self.Dense_0(point_feats)
        return torch.where(plan.valid_points[:, None], out, 0.0)


class ConvGRU(nn.Module):
    """Sparse ConvGRU cell (reference models/modules.py:200-222)."""

    def __init__(self, hidden_dim: int, input_dim: int, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = SConv3d(cin, hidden_dim, device="cpu")
        self.convr = SConv3d(cin, hidden_dim, device="cpu")
        self.convq = SConv3d(cin, hidden_dim, device="cpu")
        init_sparse_module(self, seed, device)

    def forward(self, h, x, plan: SConv3dPlan):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx, plan))
        r = torch.sigmoid(self.convr(hx, plan))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1), plan))
        return (1 - z) * h + z * q
