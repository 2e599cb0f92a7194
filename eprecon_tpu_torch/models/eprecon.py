"""EPRecon core network: occupancy init -> coarse-to-fine TSDF -> panoptic
(port of eprecon_tpu/models/eprecon.py, forward and training losses;
reference models/neucon_network.py:25-699 and models/neuralrecon.py:19-86).

Every per-stage computation runs on the fragment's dense window (24^3 /
48^3 / 96^3) with an active-voxel mask; sparse capacity-padded sets appear
only at the panoptic stage. Batch = 1 fragment. The dtype plan is the JAX
package's: back-projected volumes bf16, 3D convs bf16, tsdf/occ heads f32,
panoptic transfer and mask-feature LayerNorm bf16. BatchNorm uses batch
statistics at inference (the reference's eval semantics). With `targets`
the forward also returns the losses of a training step: occupancy init,
tsdf/occ per stage against the GT fused into per-level target volumes,
and the panoptic set criterion. Where autograd records, `cfg.remat_mode`
picks what the backward recomputes, at the JAX package's boundaries
(`remat_boundaries`, models/layers.remat).

Channel plan (alpha=1):
  ch_init     = [80, 40, 24]     back-projected image feats per stage
  ch_in       = [80, 138, 74]    U-Net input (volume ++ upsampled prev)
  channels    = [96, 48, 24]     U-Net output (voxel branch)
  gru_channels= [176, 88, 48]    voxel ++ img branches fused by the GRU
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from eprecon_tpu_torch.config import ModelConfig
from eprecon_tpu_torch.fragment_io import (FragmentInputs,  # noqa: F401
                                          RecurrentState)
from eprecon_tpu_torch.models import dense3d
from eprecon_tpu_torch.models.backbone import MnasMulti, get_depths
from eprecon_tpu_torch.models.blocks import Linear4xTrans
from eprecon_tpu_torch.models.dense3d import SubMConv3dDense
from eprecon_tpu_torch.models.gru_fusion import (DenseGlobalLevel,
                                                 DenseGRUFusion,
                                                 DenseTargetLevel,
                                                 fuse_target_window)
from eprecon_tpu_torch.models.layers import (LayerNorm, init_module, mask3,
                                             remat)
from eprecon_tpu_torch.models.occupancy_init import OccupancyInitialization
from eprecon_tpu_torch.models.panoptic.criterion import (build_targets,
                                                         set_criterion)
from eprecon_tpu_torch.models.panoptic.decoder import MaskedTransformerDecoder
from eprecon_tpu_torch.models.unet_dense import DenseUNet
from eprecon_tpu_torch.ops import sparse as sp
from eprecon_tpu_torch.ops.back_project import back_project_window
from eprecon_tpu_torch.ops.grid import dense_coords
from eprecon_tpu_torch.train.losses import occupancy_init_loss, tsdf_occ_loss

BF16 = torch.bfloat16


class FragmentTargets(NamedTuple):
    """Dense GT windows per pyramid level l (0 = finest), as the data
    pipeline makes them (reference datasets/transforms.py:262-365)."""
    tsdf: Tuple[torch.Tensor, ...]      # ([96^3], [48^3], [24^3]) f32
    occ: Tuple[torch.Tensor, ...]       # bool, same shapes
    semantic: Optional[torch.Tensor]    # [96^3] nyu40 ids (finest)
    instance: Optional[torch.Tensor]    # [96^3] instance ids (finest)


REMAT_3D = ("initialization", "sp_conv", "gru_conv", "panoptic")


def remat_boundaries(mode: str) -> Tuple[str, ...]:
    """The modules the training backward recomputes under `mode`, as the
    JAX package reads model.remat_mode (eprecon.py:206,510): "none"
    nothing, "full" the backbones and every 3-D module (the occupancy
    init, each stage's U-Net, the GRU fusions' two ConvGRUs but not their
    global-map slice and writeback, the decoder), any other value the
    backbones."""
    if mode == "none":
        return ()
    return ("backbones", *REMAT_3D) if mode == "full" else ("backbones",)


def channel_plan(cfg: ModelConfig):
    d = get_depths(cfg.backbone2d.alpha)
    ch_init = [d[4], d[3], d[2]]                  # [80, 40, 24]
    channels = [96, 48, 24]
    ch_in = [ch_init[0], channels[0] + ch_init[1] + 2,
             channels[1] + ch_init[2] + 2]        # [80, 138, 74]
    return ch_init, channels, ch_in


def gru_channel_plan(cfg: ModelConfig):
    ch_init, channels, _ = channel_plan(cfg)
    return [c + i for c, i in zip(channels, ch_init)]  # [176, 88, 48]


def make_recurrent_state(cfg: ModelConfig, device=None) -> RecurrentState:
    gru_ch = gru_channel_plan(cfg)
    dtype = BF16 if cfg.global_dtype == "bfloat16" else torch.float32
    gmaps, tmaps = [], []
    for i in range(cfg.n_layer):
        interval = 2 ** (cfg.n_scales - i)
        extent = tuple(v // interval for v in cfg.global_extent)
        gmaps.append(DenseGlobalLevel.empty(extent, gru_ch[i], dtype, device))
        tmaps.append(DenseTargetLevel.empty(extent, device))
    return RecurrentState(tuple(gmaps), tuple(tmaps))


class SparseConvResidual(nn.Module):
    """SubM conv + ReLU + residual + LN on a masked dense window, bf16
    (reference models/modules.py:469-482)."""

    def __init__(self, features: int):
        super().__init__()
        self.SubMConv3dDense_0 = SubMConv3dDense(features, features)
        self.LayerNorm_0 = LayerNorm(features, dtype=BF16)

    def forward(self, vol, mask):
        out = vol + F.relu(self.SubMConv3dDense_0(vol, mask))
        return mask3(self.LayerNorm_0(out), mask)


def nearest_fine_in_cell(row_table: torch.Tensor, coarse_coords: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """Nearest active fine voxel per coarse voxel via cell alignment: the
    candidates of a coarse voxel's stride^3 cell, ordered by distance to the
    cell corner; the first present one wins.

    row_table [X, Y, Z] int fine-voxel row per cell (-1 empty);
    coarse_coords [K, 3] fine units. Returns [K] rows (0 where none)."""
    x, y, z = row_table.shape
    s = stride
    t = row_table.reshape(x // s, s, y // s, s, z // s, s)
    t = t.permute(0, 2, 4, 1, 3, 5).reshape(-1, s ** 3)
    deltas = np.stack(np.meshgrid(*([np.arange(s)] * 3), indexing="ij"),
                      -1).reshape(-1, 3)
    order = np.argsort((deltas ** 2).sum(1), kind="stable")
    t = t[:, torch.as_tensor(order, device=t.device)]
    p = coarse_coords.long() // s
    flat = ((p[:, 0] * (y // s) + p[:, 1]) * (z // s) + p[:, 2])
    cand = t[flat.clamp(0, t.shape[0] - 1)]
    first = (cand >= 0).int().argmax(dim=1)
    return cand.gather(1, first[:, None])[:, 0].clamp(min=0)


def aligned_coord_features(dim: Tuple[int, int, int], interval: int,
                           voxel_size: float, origin_partial: torch.Tensor,
                           world_to_aligned: torch.Tensor) -> torch.Tensor:
    """Aligned-camera coordinates of every window voxel, [X, Y, Z, 3]
    (meters / window extent), injected as U-Net input features."""
    coords = dense_coords(dim, origin_partial.device).float() * interval
    world = coords * voxel_size + origin_partial
    wh = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    aligned = torch.einsum("ij,xyzj->xyzi", world_to_aligned[:3], wh)
    return aligned / (max(dim) * interval * voxel_size)


class EPReconCore(nn.Module):
    """The per-fragment pipeline (reference NeuConNet.forward), batch=1."""

    def __init__(self, cfg: ModelConfig, use_running_average: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        if cfg.sparsereg_dropout:
            raise ValueError(
                "model.sparsereg_dropout=True is not supported: the JAX "
                "package's U-Net dropout (eprecon_tpu/models/unet_dense.py:"
                "76-77) draws from a 'dropout' RNG stream that no apply of "
                "the JAX package passes, so it fails at its first forward; "
                "the port has no dropout for it to match")
        self.cfg = cfg
        self.remat = remat_boundaries(cfg.remat_mode)
        ura = use_running_average
        ch_init, channels, ch_in = channel_plan(cfg)
        gru_ch = gru_channel_plan(cfg)
        d = get_depths(cfg.backbone2d.alpha)
        pan = cfg.panoptic
        self.initialization = OccupancyInitialization((d[2], d[3], d[4]),
                                                      use_running_average=ura)
        for i in range(cfg.n_layer):
            setattr(self, f"sp_conv_{i}",
                    DenseUNet(ch_in[i] + 3, 1.0 / 2 ** i, ura))
            setattr(self, f"gru_fusion_{i}",
                    DenseGRUFusion(channels[i], ch_init[i],
                                   remat="gru_conv" in self.remat))
            setattr(self, f"tsdf_pred_{i}", Linear4xTrans(channels[i], 1))
            setattr(self, f"occ_pred_{i}", Linear4xTrans(channels[i], 1))
        for p in range(3):
            setattr(self, f"panoptic_pred_{p}",
                    Linear4xTrans(gru_ch[p], pan.hidden_dim, dtype=BF16))
        for mi in range(3):
            setattr(self, f"mask_feat_{mi}", SparseConvResidual(pan.hidden_dim))
        self.panoptic = MaskedTransformerDecoder(
            num_classes=pan.num_classes, hidden_dim=pan.hidden_dim,
            num_queries=pan.num_queries, num_heads=pan.nheads,
            dim_feedforward=pan.hidden_dim * pan.dim_feedforward_mult,
            dec_layers=pan.dec_layers, generator=generator)

    def forward(self, features2d: Sequence[torch.Tensor],
                features_occ_pano: Sequence[torch.Tensor],
                frag: FragmentInputs, state: RecurrentState,
                targets: Optional[FragmentTargets] = None,
                only_train_init: bool = False, debug_outputs: bool = False):
        """features2d / features_occ_pano: 3 tensors [V, H_s, W_s, C_s]
        fine -> coarse, from the reconstruction and occupancy/panoptic
        backbones. Returns (outputs dict, losses dict, new RecurrentState);
        the global maps in `state` (and, with `targets`, its target maps)
        are updated in place. Losses are computed only with `targets`;
        `only_train_init` stops after the occupancy-init loss."""
        cfg = self.cfg
        n_scales = cfg.n_scales
        ch_init, channels, _ = channel_plan(cfg)
        outputs: Dict[str, Any] = {}
        losses: Dict[str, torch.Tensor] = {}
        f2d = [f[:, None] for f in features2d]   # [V, 1, H, W, C]
        fop = [f[:, None] for f in features_occ_pano]
        origin_b = frag.vol_origin_partial[None, :]

        # occupancy initialization (reference neucon_network.py:239-342)
        init_interval = 2 ** (n_scales - cfg.init_stage)
        init_scale = n_scales - cfg.init_stage
        init_shape = tuple(v // init_interval for v in cfg.n_vox)
        occ_logits, init_mask, _ = remat(
            self.initialization, f2d, origin_b, cfg.voxel_size,
            frag.proj_matrices[:, None, init_scale], init_shape,
            init_interval, cfg.min_view_number,
            enabled="initialization" in self.remat)
        occ_logits, init_mask = occ_logits[0], init_mask[0]
        frag_ok = init_mask.sum() >= cfg.min_init_voxels
        if debug_outputs:
            outputs["occ_init_logits"] = occ_logits
            outputs["occ_init_mask"] = init_mask
        if targets is not None:
            t_init = (1.0 - targets.tsdf[init_scale].abs()).clamp(0.0, 1.0)
            l_init = occupancy_init_loss(occ_logits.reshape(-1),
                                         t_init.reshape(-1),
                                         targets.occ[init_scale].reshape(-1),
                                         init_mask.reshape(-1))
            losses["occupancy_initialization_loss"] = torch.where(
                frag_ok, l_init, 0.0 * occ_logits.sum())
        if only_train_init:
            return outputs, losses, state

        occupied = init_mask & (torch.sigmoid(occ_logits) > cfg.occ_init_threshold)
        stage_mask = dense3d.maxpool3d(occupied, 2 ** cfg.init_stage)
        stage_mask = dense3d.dilate(dense3d.dilate(dense3d.erode(stage_mask)))

        # coarse-to-fine surface reconstruction (reference :347-511)
        new_gmaps: List[DenseGlobalLevel] = []
        new_tmaps: List[DenseTargetLevel] = []
        pano_feats_dense, pano_masks, pano_scores = [], [], []
        prev_feats = None
        for i in range(cfg.n_layer):
            interval = 2 ** (n_scales - i)
            scale = n_scales - i
            dim = tuple(v // interval for v in cfg.n_vox)
            if i > 0:
                stage_mask = dense3d.upsample_nearest2(stage_mask[..., None])[..., 0]
                prev_feats = dense3d.upsample_nearest2(prev_feats)

            volume, count = back_project_window(
                dim, interval, origin_b, cfg.voxel_size, fop[scale],
                frag.proj_matrices[:, None, scale])
            if i == 0:
                stage_mask = stage_mask & (count >= cfg.min_view_number)
            if debug_outputs:
                outputs[f"bp_vol_{i}"] = volume
                outputs[f"bp_count_{i}"] = count
                outputs[f"stage_entry_{i}"] = stage_mask

            feat = volume if prev_feats is None else torch.cat(
                [volume, prev_feats.to(BF16)], dim=-1)
            feat = torch.where(stage_mask[..., None], feat, 0)
            ac = aligned_coord_features(dim, interval, cfg.voxel_size,
                                        frag.vol_origin_partial,
                                        frag.world_to_aligned_camera)
            feat3d = remat(getattr(self, f"sp_conv_{i}"),
                           torch.cat([feat, ac.to(BF16)], dim=-1), stage_mask,
                           enabled="sp_conv" in self.remat)
            feat_all = torch.cat([feat3d.to(BF16), volume], dim=-1)

            fused, union, gmap = getattr(self, f"gru_fusion_{i}")(
                feat_all, stage_mask, state.gmaps[i], frag.rel_origins[i])
            new_gmaps.append(gmap)
            if debug_outputs:
                outputs[f"stage_unet_{i}"] = feat3d
                outputs[f"stage_fused_{i}"] = fused
                outputs[f"stage_union_{i}"] = union

            if targets is not None:
                tsdf_t, occ_t, tmap = fuse_target_window(
                    state.tmaps[i], targets.tsdf[scale], targets.occ[scale],
                    frag.rel_origins[i])
            else:
                tsdf_t = occ_t = None
                tmap = state.tmaps[i]
            new_tmaps.append(tmap)

            # f32 heads: in bf16 their gradient noise collapses occupancy
            # selection during training (see the JAX module)
            feat_v = fused[..., :channels[i]].float()
            tsdf = getattr(self, f"tsdf_pred_{i}")(feat_v)[..., 0]
            occ = getattr(self, f"occ_pred_{i}")(feat_v)[..., 0]
            if targets is not None:
                loss = tsdf_occ_loss(tsdf.reshape(-1), occ.reshape(-1),
                                     tsdf_t.reshape(-1), occ_t.reshape(-1),
                                     union.reshape(-1), cfg.pos_weight)
                losses[f"tsdf_occ_loss_{i}"] = torch.where(frag_ok, loss,
                                                           0.0 * tsdf.sum())

            occupancy = (occ > cfg.thresholds[i]) & union
            n_occ = occupancy.sum()
            frag_ok = frag_ok & (n_occ >= cfg.min_stage_voxels)
            outputs[f"n_occ_{i}"] = n_occ
            if debug_outputs:
                outputs[f"stage_tsdf_{i}"] = tsdf
                outputs[f"stage_occ_{i}"] = occ
                outputs[f"occupancy_{i}"] = occupancy

            pano_feats_dense.append(torch.where(occupancy[..., None], fused, 0.0))
            pano_masks.append(occupancy)
            # the scores order capacity overflow: no gradient through them
            pano_scores.append(occ.detach())
            if i == cfg.n_layer - 1:
                occ_target_fine = occ_t
                outputs["tsdf_window"] = torch.where(occupancy, tsdf, 1.0)
                outputs["occupancy"] = occupancy
            else:
                stage_mask = occupancy
                prev_feats = torch.cat([feat_v, tsdf[..., None], occ[..., None]],
                                       dim=-1)
                prev_feats = torch.where(occupancy[..., None], prev_feats, 0.0)
        outputs["frag_ok"] = frag_ok
        new_state = RecurrentState(tuple(new_gmaps), tuple(new_tmaps))

        # panoptic stage (reference :516-622): coarse voxels must sit on a
        # fine voxel's cell -> max-pool of the fine mask
        fine_mask = pano_masks[2]
        pano_masks[1] = pano_masks[1] & dense3d.maxpool3d(fine_mask, 2)
        pano_masks[0] = pano_masks[0] & dense3d.maxpool3d(fine_mask, 4)
        lvl_dense = []
        for p in range(3):
            f = getattr(self, f"panoptic_pred_{p}")(pano_feats_dense[p])
            lvl_dense.append(torch.where(pano_masks[p][..., None], f, 0))
        mf = lvl_dense[2]
        for mi in range(3):
            mf = getattr(self, f"mask_feat_{mi}")(mf, fine_mask)

        caps = cfg.voxel_capacity
        pano_ch = cfg.panoptic.hidden_dim
        lvl_feats, lvl_coords, lvl_valid = [], [], []
        overflow = torch.zeros((), dtype=torch.int32, device=fine_mask.device)
        for p in range(2):
            stride = 2 ** (n_scales - p)
            svx, ovf = sp.dense_to_sparse(lvl_dense[p], pano_masks[p], caps[p],
                                          score=pano_scores[p])
            lvl_feats.append(svx.feats)
            lvl_coords.append(svx.coords[:, 1:] * stride)
            lvl_valid.append(svx.valid)
            overflow = overflow + ovf
        n_fine = int(np.prod(cfg.n_vox))
        fine_coords = torch.cat([
            torch.zeros(n_fine, 1, dtype=torch.int32, device=fine_mask.device),
            dense_coords(cfg.n_vox, fine_mask.device).reshape(-1, 3)], dim=1)
        fine_sv, (fine_feats, fine_tsdf), ovf = sp.compact(
            pano_masks[2].reshape(-1), fine_coords, caps[2],
            torch.cat([lvl_dense[2], mf], dim=-1).reshape(n_fine, -1),
            outputs["tsdf_window"].reshape(n_fine, 1),
            score=pano_scores[2].reshape(-1))
        lvl_feats.append(fine_feats[:, :pano_ch])
        lvl_coords.append(fine_sv.coords[:, 1:])
        lvl_valid.append(fine_sv.valid)
        mask_feats = fine_feats[:, pano_ch:2 * pano_ch]
        outputs["coords"] = fine_sv.coords
        outputs["tsdf"] = fine_tsdf[:, 0]
        outputs["valid"] = fine_sv.valid
        outputs["overflow"] = overflow + ovf

        k_fine = fine_sv.coords.shape[0]
        fine_rows = sp.sparse_to_dense(
            fine_sv.coords[:, 1:],
            torch.arange(k_fine, dtype=torch.float32, device=fine_mask.device)[:, None],
            fine_sv.valid, cfg.n_vox, default=-1.0)[..., 0].long()
        mask_idx = [nearest_fine_in_cell(fine_rows, lvl_coords[0], 4),
                    nearest_fine_in_cell(fine_rows, lvl_coords[1], 2),
                    torch.arange(k_fine, device=fine_mask.device)]
        dec_out = remat(self.panoptic, lvl_feats, lvl_coords, lvl_valid,
                        mask_feats, tuple(cfg.n_vox), mask_idx,
                        enabled="panoptic" in self.remat)
        outputs["pred_logits"] = dec_out.pred_logits[-1]
        outputs["pred_masks"] = dec_out.pred_masks[-1]
        outputs["panoptic_coords"] = fine_sv.coords
        outputs["panoptic_valid"] = fine_sv.valid

        # panoptic loss on the occupied GT voxels (reference :589-605)
        if targets is not None and targets.semantic is not None:
            fc = fine_sv.coords[:, 1:].long()
            at = (fc[:, 0], fc[:, 1], fc[:, 2])
            sup = fine_sv.valid & occ_target_fine[at]
            ptargets = build_targets(
                torch.where(sup, targets.semantic[at], 0),
                torch.where(sup, targets.instance[at], 0), sup,
                cfg.panoptic.max_instances, cfg.panoptic.min_instance_voxels)
            pan = cfg.panoptic
            pl = set_criterion(dec_out.pred_logits, dec_out.pred_masks,
                               ptargets, pan.class_weight, pan.mask_weight,
                               pan.dice_weight, pan.no_object_weight)
            losses["panoptic_loss"] = torch.where(
                frag_ok, pl, 0.0 * dec_out.pred_masks.sum())
        return outputs, losses, new_state


class EPRecon(nn.Module):
    """Top module: dual backbones + core (reference models/neuralrecon.py)."""

    def __init__(self, cfg: ModelConfig, use_running_average: bool = False,
                 seed: int = 0):
        """Parameters are random from `seed`, each drawn from the
        initialiser its flax module names (Xavier for the submanifold 3D
        convs, the heads and attention, flax's truncated lecun-normal for
        the other convs and dense layers); load trained or JAX-made
        weights with convert.variables_to_torch."""
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        alpha = cfg.backbone2d.alpha
        self.backbone2d = MnasMulti(alpha, use_running_average)
        self.backbone_occ_pano = MnasMulti(alpha, use_running_average)
        self.neucon_net = EPReconCore(cfg, use_running_average, generator=gen)
        init_module(self, gen)
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std),
                             persistent=False)

    def normalize(self, imgs: torch.Tensor) -> torch.Tensor:
        """BGR mean/std normalisation; uint8 images are cast to f32 first
        (the JAX package's uint8 transfer path)."""
        if not imgs.is_floating_point():
            imgs = imgs.float()
        return (imgs - self.pixel_mean) / self.pixel_std

    def forward(self, imgs: torch.Tensor, frag: FragmentInputs,
                state: RecurrentState,
                targets: Optional[FragmentTargets] = None,
                only_train_init: bool = False, debug_outputs: bool = False):
        """imgs [V, H, W, 3] BGR (float or uint8). Returns (outputs,
        losses, new_state); with `targets`, losses holds the weighted
        "total_loss" beside its terms."""
        x = self.normalize(imgs)
        recompute = "backbones" in remat_boundaries(self.cfg.remat_mode)
        feats2d = remat(self.backbone2d, x, enabled=recompute)
        feats_op = remat(self.backbone_occ_pano, x, enabled=recompute)
        outputs, losses, new_state = self.neucon_net(
            feats2d, feats_op, frag, state, targets, only_train_init,
            debug_outputs)
        if losses:
            losses["total_loss"] = weighted_total(self.cfg, losses)
        return outputs, losses, new_state


LOSS_ORDER = ("occupancy_initialization_loss", "tsdf_occ_loss_0",
              "tsdf_occ_loss_1", "tsdf_occ_loss_2", "panoptic_loss")


def weighted_total(cfg: ModelConfig, losses: Dict[str, torch.Tensor]):
    """The weighted sum of the loss terms, in the reference's order
    (neuralrecon.py:79-84; eprecon.py:519-532 of the JAX package)."""
    lw = {"occupancy_initialization_loss": 1.0,
          "tsdf_occ_loss_0": cfg.lw[0], "tsdf_occ_loss_1": cfg.lw[1],
          "tsdf_occ_loss_2": cfg.lw[2],
          "panoptic_loss": cfg.lw[3] if len(cfg.lw) > 3 else 1.0}
    total = 0.0
    for k in LOSS_ORDER:
        if k in losses:
            total = total + lw[k] * losses[k]
    return total
