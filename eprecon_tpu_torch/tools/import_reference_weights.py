"""Reference-checkpoint importer: a PyTorch EPRecon checkpoint of the
reference (torchsparse / spconv / torchvision modules) -> the port's
EPRecon state_dict (own copy of eprecon_tpu/tools/import_reference_weights.py).

Maps every learned tensor of the reference model (reference
models/neuralrecon.py:19-44 module tree: backbone2d / backbone_occ_pano
MnasMulti, neucon_net.{initialization, sp_convs, gru_fusion, tsdf_preds,
occ_preds, panoptic_preds, panoptic_feat_fusion.mask_feat_extraction_*,
panoptic decoder}). The entry tables name, per reference tensor, its
expected shape, its place in the flax-layout variables tree the JAX
package uses, and the numpy transform into that layout; the tree then goes
through convert.tree_to_torch into the port's layout, so the result is by
construction the JAX importer followed by the port's flax converter.

Usage:
  python -m eprecon_tpu_torch.tools.import_reference_weights \\
      --torch_ckpt model_000099.ckpt [--fingerprint fp.json] --out model.pt

The output is {"model": state_dict}, which train/checkpoint.restore_model
and the CLI's `loadckpt` (run_test) read.

Layout notes (reference layout -> flax layout; convert.py then maps flax
-> port):
  * torch Linear weight [O, I]        -> flax Dense kernel [I, O]
  * torch Conv2d weight [O, I, kh, kw]-> flax Conv kernel [kh, kw, I, O]
  * spconv 2.x SubMConv3d weight KRSC [O, kd, kh, kw, I]
                                      -> flax Conv3d kernel [kd, kh, kw, I, O]
  * torchsparse 2.0 Conv3d kernel [K, I, O]:
      - odd kernel (ks=3, K=27): offsets enumerated x-fastest
        (torchsparse get_kernel_offsets) -> reshape (z, y, x, I, O),
        transpose to (x, y, z, I, O)
      - even kernel (ks=2, K=8): offsets enumerated z-fastest ->
        reshape (x, y, z, I, O) directly; offsets are {0, 1} so a stride-2
        VALID dense conv indexes identically
      - ks=1: weight [I, O] == flax Dense kernel
    Which enumeration a checkpoint was written with is checked against an
    activation fingerprint (tools/fingerprint.py, --fingerprint).
  * torch MultiheadAttention in_proj_weight [3C, C] splits into q/k/v rows
  * BatchNorm weight/bias/running_mean/running_var ->
      scale/bias (params) + mean/var (batch_stats)
  * torchsparse convs carry NO bias -> the matching biases are zero
  * the dense U-Net input gains 3 trailing aligned-coordinate channels
    (models/unet_dense.py docstring): the stem kernel's 3 extra input rows
    are zero, so the converted model computes the reference function of
    the image features.

Keys deliberately skipped (no effect on the forward pass):
  * neucon_net.panoptic_feat_fusion.{img2panoptic_0, occ2panoptic_0,
    pre_fusion, pre_fusion_0, pre_fusion_1}: dead code in the reference
    forward (only generate_mask_features is called,
    reference models/neucon_network.py:557-561)
  * neucon_net.criterion.empty_weight: a derived constant buffer
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# channel plan constants (reference models/neucon_network.py:31-39, alpha=1)
# ---------------------------------------------------------------------------
CH_INIT = [80, 40, 24]
CHANNELS = [96, 48, 24]
CH_IN = [80, 138, 74]
GRU_CH = [176, 88, 48]
PANO_CH = 48
NUM_QUERIES = 80
NUM_CLASSES = 20
DEC_LAYERS = 6
MNAS_DEPTHS = [32, 16, 24, 40, 80, 96, 192, 320]


class Entry(NamedTuple):
    """One tensor mapping: torch state_dict key → flax tree leaf."""
    src: str                      # torch key (without 'module.' prefix)
    src_shape: Tuple[int, ...]    # expected torch shape (validated)
    collection: str               # 'params' | 'batch_stats' | 'buffers'
    dst: Tuple[str, ...]          # path inside the collection
    transform: str                # name in TRANSFORMS


class ZeroEntry(NamedTuple):
    """A flax leaf set to zeros because the torch module has no such tensor
    (e.g. bias of a bias-less torchsparse conv)."""
    collection: str
    dst: Tuple[str, ...]


def _t_lin(w):
    return np.ascontiguousarray(np.transpose(w, (1, 0)))


def _t_conv2d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _t_spconv(w):
    # KRSC [O, kd, kh, kw, I] → [kd, kh, kw, I, O]
    return np.ascontiguousarray(np.transpose(w, (1, 2, 3, 4, 0)))


def _t_ts3(w):
    # [27, I, O], x-fastest offsets → [kx, ky, kz, I, O]
    k, i, o = w.shape
    assert k == 27, w.shape
    return np.ascontiguousarray(
        w.reshape(3, 3, 3, i, o).transpose(2, 1, 0, 3, 4))


def _t_ts2(w):
    # [8, I, O], z-fastest (even-kernel) offsets → [kx, ky, kz, I, O]
    k, i, o = w.shape
    assert k == 8, w.shape
    return np.ascontiguousarray(w.reshape(2, 2, 2, i, o))


def _t_ts2t(w):
    # transposed even-kernel conv: flax ConvTranspose applies the kernel
    # spatially FLIPPED relative to torch conv_transpose3d (oracle-tested in
    # tests/test_import_reference.py::test_ts2_up_layout_oracle);
    # convert.tree_to_torch flips it back, so the port's ConvTranspose
    # weight is the torch kernel as placed
    return np.ascontiguousarray(_t_ts2(w)[::-1, ::-1, ::-1])


def _t_ts3_pad3(w):
    """ts3 + 3 trailing zero input rows (aligned-coord channels of the
    dense U-Net stem — see module docstring)."""
    k = _t_ts3(w)
    pad = np.zeros(k.shape[:3] + (3, k.shape[4]), k.dtype)
    return np.concatenate([k, pad], axis=3)


TRANSFORMS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "id": lambda w: np.asarray(w),
    "lin": _t_lin,
    "conv2d": _t_conv2d,
    "spconv": _t_spconv,
    "ts3": _t_ts3,
    "ts3_pad3": _t_ts3_pad3,
    "ts2": _t_ts2,
    "ts2T": _t_ts2t,
    "ts1": lambda w: np.asarray(w),   # [I, O] already
}


# ---------------------------------------------------------------------------
# entry helpers: each returns the entries (and zero entries) of one module
# ---------------------------------------------------------------------------

def _bn(src: str, c: int, dst: Tuple[str, ...]) -> List[Entry]:
    return [
        Entry(f"{src}.weight", (c,), "params", dst + ("scale",), "id"),
        Entry(f"{src}.bias", (c,), "params", dst + ("bias",), "id"),
        Entry(f"{src}.running_mean", (c,), "batch_stats", dst + ("mean",), "id"),
        Entry(f"{src}.running_var", (c,), "batch_stats", dst + ("var",), "id"),
    ]


def _ln(src: str, c: int, dst: Tuple[str, ...]) -> List[Entry]:
    return [
        Entry(f"{src}.weight", (c,), "params", dst + ("scale",), "id"),
        Entry(f"{src}.bias", (c,), "params", dst + ("bias",), "id"),
    ]


def _linear(src: str, ci: int, co: int, dst: Tuple[str, ...],
            bias: bool = True) -> List[Entry]:
    es = [Entry(f"{src}.weight", (co, ci), "params", dst + ("kernel",), "lin")]
    if bias:
        es.append(Entry(f"{src}.bias", (co,), "params", dst + ("bias",), "id"))
    return es


def _conv2d(src: str, ci: int, co: int, k: int, dst: Tuple[str, ...],
            bias: bool = True) -> List[Entry]:
    es = [Entry(f"{src}.weight", (co, ci, k, k), "params",
                dst + ("kernel",), "conv2d")]
    if bias:
        es.append(Entry(f"{src}.bias", (co,), "params", dst + ("bias",), "id"))
    return es


def _spconv(src: str, ci: int, co: int, k: int,
            dst: Tuple[str, ...]) -> List[Entry]:
    return [
        Entry(f"{src}.weight", (co, k, k, k, ci), "params",
              dst + ("kernel",), "spconv"),
        Entry(f"{src}.bias", (co,), "params", dst + ("bias",), "id"),
    ]


def _conv2d_block(src: str, ci: int, co: int, k: int,
                  dst: Tuple[str, ...]) -> List[Entry]:
    """Conv2d_Block {conv, bn} → {Conv_0, BatchNorm_0}
    (reference models/modules.py:372-382)."""
    return (_conv2d(f"{src}.conv", ci, co, k, dst + ("Conv_0",))
            + _bn(f"{src}.bn", co, dst + ("BatchNorm_0",)))


def _fusion_block(src: str, c: int, dst: Tuple[str, ...]) -> List[Entry]:
    """Fusion_Block (reference models/modules.py:313-338) →
    FusionBlock {Conv_0/BatchNorm_0, Conv_1/BatchNorm_1, ELAN2D_0}."""
    es = (_conv2d(f"{src}.conv1", c, c, 3, dst + ("Conv_0",))
          + _bn(f"{src}.bn1", c, dst + ("BatchNorm_0",))
          + _conv2d(f"{src}.conv2", c, c, 1, dst + ("Conv_1",))
          + _bn(f"{src}.bn2", c, dst + ("BatchNorm_1",)))
    # ELAN (reference :340-370): conv1..conv7 → Conv2dBlock_0..6
    e = dst + ("ELAN2D_0",)
    h = c // 2
    plan = [(c, c, 1), (c, c, 1), (c, h, 3), (h, h, 3), (h, h, 3), (h, h, 3),
            (4 * c, c, 1)]
    for j, (ci, co, k) in enumerate(plan):
        es += _conv2d_block(f"{src}.ELAN.conv{j+1}", ci, co, k,
                            e + (f"Conv2dBlock_{j}",))
    return es


def _linear4x(src: str, ci: int, co: int, dst: Tuple[str, ...]) -> List[Entry]:
    """Linear4xTrans (reference models/modules.py:273-311) →
    {Dense_0, LayerNorm_0, Dense_1, LayerNorm_1, Dense_2}."""
    return (_linear(f"{src}.linear1", ci, 4 * ci, dst + ("Dense_0",))
            + _ln(f"{src}.norm1", 4 * ci, dst + ("LayerNorm_0",))
            + _linear(f"{src}.linear2", 4 * ci, ci, dst + ("Dense_1",))
            + _ln(f"{src}.norm2", ci, dst + ("LayerNorm_1",))
            + _linear(f"{src}.linear3", ci, co, dst + ("Dense_2",)))


def _subm_block(src: str, ci: int, co: int, k: int,
                dst: Tuple[str, ...]) -> List[Entry]:
    """SubMconv3dBlock {conv spconv, ln} (reference models/modules.py:440-452)
    → SubMConv3dBlockDense {SubMConv3dDense_0/Conv_0, LayerNorm_0}."""
    return (_spconv(f"{src}.conv", ci, co, k,
                    dst + ("SubMConv3dDense_0", "Conv_0"))
            + _ln(f"{src}.ln", co, dst + ("LayerNorm_0",)))


def _sparse_elan(src: str, c: int, dst: Tuple[str, ...]) -> List[Entry]:
    """Spares3dELAN (reference models/modules.py:401-438) →
    Sparse3dELANDense {SubMConv3dBlockDense_0..6}."""
    h = c // 2
    plan = [(c, c, 1), (c, c, 1), (c, h, 3), (h, h, 3), (h, h, 3), (h, h, 3),
            (4 * c, c, 1)]
    es: List[Entry] = []
    for j, (ci, co, k) in enumerate(plan):
        es += _subm_block(f"{src}.conv{j+1}", ci, co, k,
                          dst + (f"SubMConv3dBlockDense_{j}",))
    return es


# --------------------------- MnasMulti backbone ----------------------------

def _inverted_residual(src: str, ci: int, co: int, k: int, expansion: int,
                       dst: Tuple[str, ...]) -> List[Entry]:
    mid = ci * expansion
    es: List[Entry] = []
    es += [Entry(f"{src}.layers.0.weight", (mid, ci, 1, 1), "params",
                 dst + ("Conv_0", "kernel"), "conv2d")]
    es += _bn(f"{src}.layers.1", mid, dst + ("BatchNorm_0",))
    es += [Entry(f"{src}.layers.3.weight", (mid, 1, k, k), "params",
                 dst + ("Conv_1", "kernel"), "conv2d")]
    es += _bn(f"{src}.layers.4", mid, dst + ("BatchNorm_1",))
    es += [Entry(f"{src}.layers.6.weight", (co, mid, 1, 1), "params",
                 dst + ("Conv_2", "kernel"), "conv2d")]
    es += _bn(f"{src}.layers.7", co, dst + ("BatchNorm_2",))
    return es


def backbone_entries(src: str, dst_root: str) -> List[Entry]:
    """MnasMulti (reference models/backbone.py:22-77; conv0 = torchvision
    layers 0-8, conv1 = layers 9, conv2 = layers 10, + 5 FPN convs)."""
    d = MNAS_DEPTHS
    r = (dst_root,)
    es: List[Entry] = []
    # stem (torchvision layers 0..7 inside conv0)
    es += [Entry(f"{src}.conv0.0.weight", (d[0], 3, 3, 3), "params",
                 r + ("Conv_0", "kernel"), "conv2d")]
    es += _bn(f"{src}.conv0.1", d[0], r + ("BatchNorm_0",))
    es += [Entry(f"{src}.conv0.3.weight", (d[0], 1, 3, 3), "params",
                 r + ("Conv_1", "kernel"), "conv2d")]
    es += _bn(f"{src}.conv0.4", d[0], r + ("BatchNorm_1",))
    es += [Entry(f"{src}.conv0.6.weight", (d[1], d[0], 1, 1), "params",
                 r + ("Conv_2", "kernel"), "conv2d")]
    es += _bn(f"{src}.conv0.7", d[1], r + ("BatchNorm_2",))
    # MB stacks: conv0.8 / conv1 / conv2 (each 3 InvertedResiduals)
    stacks = [(f"{src}.conv0.8", d[1], d[2], 3, 3, "MBStack_0"),
              (f"{src}.conv1", d[2], d[3], 5, 3, "MBStack_1"),
              (f"{src}.conv2", d[3], d[4], 5, 6, "MBStack_2")]
    for sp, ci, co, k, e, name in stacks:
        es += _inverted_residual(f"{sp}.0", ci, co, k, e,
                                 r + (name, "InvertedResidual_0"))
        for b in (1, 2):
            es += _inverted_residual(f"{sp}.{b}", co, co, k, e,
                                     r + (name, f"InvertedResidual_{b}"))
    # FPN (reference backbone.py:47-58): out1, inner1, out2, inner2, out3
    es += _conv2d(f"{src}.out1", d[4], d[4], 1, r + ("Conv_3",), bias=False)
    es += _conv2d(f"{src}.inner1", d[3], d[4], 1, r + ("Conv_4",), bias=True)
    es += _conv2d(f"{src}.out2", d[4], d[3], 3, r + ("Conv_5",), bias=False)
    es += _conv2d(f"{src}.inner2", d[2], d[4], 1, r + ("Conv_6",), bias=True)
    es += _conv2d(f"{src}.out3", d[4], d[2], 3, r + ("Conv_7",), bias=False)
    return es


# ------------------------- occupancy initialization ------------------------

def initialization_entries() -> List[Entry]:
    """Occupancy_Initialization (reference
    models/occupancy_initialization.py:11-38) → neucon_net/initialization."""
    src = "neucon_net.initialization"
    r = ("neucon_net", "initialization")
    ff = r + ("InitFeatureFusion_0",)
    es: List[Entry] = []
    es += _fusion_block(f"{src}.self_fusion_1x", CH_INIT[0],
                        ff + ("FusionBlock_0",))
    es += _fusion_block(f"{src}.self_fusion_2x", CH_INIT[1],
                        ff + ("FusionBlock_1",))
    es += _fusion_block(f"{src}.self_fusion_4x", CH_INIT[2],
                        ff + ("FusionBlock_2",))
    ch_all = sum(CH_INIT)
    es += _conv2d_block(f"{src}.fusion_down", ch_all, 32, 1,
                        ff + ("Conv2dBlock_0",))
    for j in range(4):
        es += (_conv2d(f"{src}.post_fusion_{j+1}.conv", 32, 32, 3,
                       ff + (f"Conv2dResidualBlock_{j}", "Conv_0"))
               + _bn(f"{src}.post_fusion_{j+1}.bn", 32,
                     ff + (f"Conv2dResidualBlock_{j}", "BatchNorm_0")))
    es += _bn(f"{src}.norm0", 32, r + ("norm0",))
    es += _sparse_elan(f"{src}.similary_1", 32, r + ("Sparse3dELANDense_0",))
    for j in (1, 2, 3):
        es += _spconv(f"{src}.subm{j}.sparsesubmconv3d", 32, 32, 3,
                      r + (f"subm{j}", "Conv_0"))
        es += _ln(f"{src}.norm{j}", 32, r + (f"norm{j}", "LayerNorm_0"))
    es += _spconv(f"{src}.subm4.sparsesubmconv3d", 32, 1, 3,
                  r + ("subm4", "Conv_0"))
    es += _bn(f"{src}.norm4", 1, r + ("norm4",))
    return es


# ------------------------------ SPVCNN U-Nets ------------------------------

def _res_block(src: str, ci: int, co: int, dst: Tuple[str, ...]
               ) -> Tuple[List[Entry], List[ZeroEntry]]:
    """torchsparse ResidualBlock (reference models/modules.py:46-72) →
    DenseResidualBlock."""
    es = [Entry(f"{src}.net.0.kernel", (27, ci, co), "params",
                dst + ("SubMConv3dDense_0", "Conv_0", "kernel"), "ts3")]
    es += _bn(f"{src}.net.1", co, dst + ("MaskedBatchNorm3d_0",))
    es += [Entry(f"{src}.net.3.kernel", (27, co, co), "params",
                 dst + ("SubMConv3dDense_1", "Conv_0", "kernel"), "ts3")]
    es += _bn(f"{src}.net.4", co, dst + ("MaskedBatchNorm3d_1",))
    zs = [ZeroEntry("params", dst + ("SubMConv3dDense_0", "Conv_0", "bias")),
          ZeroEntry("params", dst + ("SubMConv3dDense_1", "Conv_0", "bias"))]
    if ci != co:
        es += [Entry(f"{src}.downsample.0.kernel", (ci, co), "params",
                     dst + ("Dense_0", "kernel"), "ts1")]
        es += _bn(f"{src}.downsample.1", co, dst + ("MaskedBatchNorm3d_2",))
    return es, zs


def spvcnn_entries(stage: int) -> Tuple[List[Entry], List[ZeroEntry]]:
    """SPVCNN (reference models/modules.py:75-175, cr=1/2^stage) →
    neucon_net/sp_conv_{stage} DenseUNet."""
    cr = 1.0 / 2 ** stage
    cs = [int(cr * v) for v in (32, 64, 128, 96, 96)]
    cin = CH_IN[stage]
    src = f"neucon_net.sp_convs.{stage}"
    r = ("neucon_net", f"sp_conv_{stage}")
    es: List[Entry] = []
    zs: List[ZeroEntry] = []

    es += [Entry(f"{src}.stem.0.kernel", (27, cin, cs[0]), "params",
                 r + ("stem_conv", "Conv_0", "kernel"), "ts3_pad3")]
    zs += [ZeroEntry("params", r + ("stem_conv", "Conv_0", "bias"))]
    es += _bn(f"{src}.stem.1", cs[0], r + ("stem_bn",))

    # down path
    for d, (ci, co) in ((1, (cs[0], cs[1])), (2, (cs[1], cs[2]))):
        es += [Entry(f"{src}.stage{d}.0.net.0.kernel", (8, ci, ci), "params",
                     r + (f"down{d}", "Conv_0", "kernel"), "ts2")]
        es += _bn(f"{src}.stage{d}.0.net.1", ci, r + (f"down{d}_bn",))
        e1, z1 = _res_block(f"{src}.stage{d}.1", ci, co,
                            r + (f"res{d}a",))
        e2, z2 = _res_block(f"{src}.stage{d}.2", co, co,
                            r + (f"res{d}b",))
        es += e1 + e2
        zs += z1 + z2

    # up path
    for u, (ci, co, skip) in ((1, (cs[2], cs[3], cs[1])),
                              (2, (cs[3], cs[4], cs[0]))):
        es += [Entry(f"{src}.up{u}.0.net.0.kernel", (8, ci, co), "params",
                     r + (f"up{u}", "ConvTranspose_0", "kernel"), "ts2T")]
        es += _bn(f"{src}.up{u}.0.net.1", co, r + (f"up{u}_bn",))
        e1, z1 = _res_block(f"{src}.up{u}.1.0", co + skip, co,
                            r + (f"res{u+2}a",))
        e2, z2 = _res_block(f"{src}.up{u}.1.1", co, co,
                            r + (f"res{u+2}b",))
        es += e1 + e2
        zs += z1 + z2

    # point transforms (Linear + BN1d; reference modules.py:131-144)
    es += _linear(f"{src}.point_transforms.0.0", cs[0], cs[2],
                  r + ("point_transform0",))
    es += _bn(f"{src}.point_transforms.0.1", cs[2], r + ("pt0_bn",))
    es += _linear(f"{src}.point_transforms.1.0", cs[2], cs[4],
                  r + ("point_transform1",))
    es += _bn(f"{src}.point_transforms.1.1", cs[4], r + ("pt1_bn",))
    return es, zs


# -------------------------------- GRU fusion -------------------------------

def gru_entries() -> Tuple[List[Entry], List[ZeroEntry]]:
    """GRUFusion feature mode (reference models/gru_fusion.py:44-57:
    fusion_nets_voxel/img per scale, each ConvGRU of 3 SConv3d) →
    neucon_net/gru_fusion_{i}/{gru_voxel, gru_img}/{convzr, convq}.

    The flax GRU fuses the z and r gates into one conv of 2x output channels
    (models/unet_dense.py DenseConvGRU): convz/convr land in temporary
    `convzr__z` / `convzr__r` slots that fuse_zr_gates() concatenates along
    the output axis after conversion.
    """
    es: List[Entry] = []
    zs: List[ZeroEntry] = []
    for i in range(3):
        for branch, ch in (("voxel", CHANNELS[i]),
                           ("img", GRU_CH[i] - CHANNELS[i])):
            base = ("neucon_net", f"gru_fusion_{i}", f"gru_{branch}")
            for gate, dst in (("convz", base + ("convzr__z",)),
                              ("convr", base + ("convzr__r",)),
                              ("convq", base + ("convq",))):
                src = f"neucon_net.gru_fusion.fusion_nets_{branch}.{i}.{gate}"
                es += [Entry(f"{src}.net.kernel", (27, 2 * ch, ch), "params",
                             dst + ("conv", "Conv_0", "kernel"), "ts3")]
                zs += [ZeroEntry("params", dst + ("conv", "Conv_0", "bias"))]
                es += _linear(f"{src}.point_transforms.0", 2 * ch, ch,
                              dst + ("point_transform",))
    return es, zs


def fuse_zr_gates(tree: Dict) -> Dict:
    """Concatenate converted convz/convr leaves into the fused convzr module
    (output-axis concat: out = [z | r], matching DenseConvGRU's split)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if "convzr__z" in v:
                zt, rt = v.pop("convzr__z"), v.pop("convzr__r")
                fused = _concat_last(zt, rt)
                v = dict(v)
                v["convzr"] = fused
            out[k] = fuse_zr_gates(v) if isinstance(v, dict) else v
        else:
            out[k] = v
    return out


def _concat_last(a, b):
    if isinstance(a, dict):
        return {k: _concat_last(a[k], b[k]) for k in a}
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=-1)


# ----------------------------- prediction heads ----------------------------

def heads_entries() -> List[Entry]:
    es: List[Entry] = []
    for i in range(3):
        es += _linear4x(f"neucon_net.tsdf_preds.{i}", CHANNELS[i], 1,
                        ("neucon_net", f"tsdf_pred_{i}"))
        es += _linear4x(f"neucon_net.occ_preds.{i}", CHANNELS[i], 1,
                        ("neucon_net", f"occ_pred_{i}"))
        es += _linear4x(f"neucon_net.panoptic_preds.{i}", GRU_CH[i], PANO_CH,
                        ("neucon_net", f"panoptic_pred_{i}"))
    # mask features: panoptic_feat_fusion.mask_feat_extraction_{0..2}
    # (reference models/modules.py:569-580 SparseConv3d_Residual)
    for m in range(3):
        src = f"neucon_net.panoptic_feat_fusion.mask_feat_extraction_{m}"
        dst = ("neucon_net", f"mask_feat_{m}")
        es += _spconv(f"{src}.SConv3d.sparsesubmconv3d", PANO_CH, PANO_CH, 3,
                      dst + ("SubMConv3dDense_0", "Conv_0"))
        es += _ln(f"{src}.norm", PANO_CH, dst + ("LayerNorm_0",))
    return es


# ----------------------------- panoptic decoder ----------------------------

def decoder_entries() -> List[Entry]:
    """MultiScaleMaskedTransformerDecoder (reference
    models/mask3dformer.py:202-334) → neucon_net/panoptic."""
    c = PANO_CH
    src = "neucon_net.panoptic"
    r = ("neucon_net", "panoptic")
    es: List[Entry] = []
    es += [Entry(f"{src}.query_feat.weight", (NUM_QUERIES, c), "params",
                 r + ("query_feat",), "id"),
           Entry(f"{src}.query_embed.weight", (NUM_QUERIES, c), "params",
                 r + ("query_embed",), "id"),
           Entry(f"{src}.level_embed.weight", (3, c), "params",
                 r + ("level_embed",), "id"),
           Entry(f"{src}.pos_enc.gauss_B", (3, c // 2), "buffers",
                 r + ("FourierPositionEncoding_0", "gauss_B"), "id")]
    for j in range(DEC_LAYERS):
        for kind, tsrc in (("cross", "transformer_cross_attention_layers"),
                           ("self", "transformer_self_attention_layers")):
            attn = "multihead_attn" if kind == "cross" else "self_attn"
            base = f"{src}.{tsrc}.{j}.{attn}"
            dst = r + (f"{kind}_{j}",)
            # in_proj [3C, C] splits into q/k/v (handled by transform tags)
            for qi, name in enumerate(("q", "k", "v")):
                es += [Entry(f"{base}.in_proj_weight", (3 * c, c), "params",
                             dst + (name, "kernel"), f"inproj_w{qi}"),
                       Entry(f"{base}.in_proj_bias", (3 * c,), "params",
                             dst + (name, "bias"), f"inproj_b{qi}")]
            es += _linear(f"{base}.out_proj", c, c, dst + ("out",))
            es += _ln(f"{src}.{tsrc}.{j}.norm", c,
                      r + (f"{kind}_norm_{j}",))
        es += _linear(f"{src}.transformer_ffn_layers.{j}.linear1", c, 4 * c,
                      r + (f"ffn1_{j}",))
        es += _linear(f"{src}.transformer_ffn_layers.{j}.linear2", 4 * c, c,
                      r + (f"ffn2_{j}",))
        es += _ln(f"{src}.transformer_ffn_layers.{j}.norm", c,
                  r + (f"ffn_norm_{j}",))
    es += _ln(f"{src}.decoder_norm", c, r + ("decoder_norm",))
    es += _linear(f"{src}.class_embed", c, NUM_CLASSES + 1,
                  r + ("class_embed",))
    # mask_embed MLP (3 layers C → 4C → 4C → C per our blocks.MLP(hidden=4C))
    es += _linear(f"{src}.mask_embed.layers.0", c, 4 * c,
                  r + ("mask_embed", "Dense_0"))
    es += _linear(f"{src}.mask_embed.layers.1", 4 * c, 4 * c,
                  r + ("mask_embed", "Dense_1"))
    es += _linear(f"{src}.mask_embed.layers.2", 4 * c, c,
                  r + ("mask_embed", "Dense_2"))
    return es


def _split3(w: np.ndarray, part: int) -> np.ndarray:
    c = w.shape[0] // 3
    return w[part * c:(part + 1) * c]


def all_entries() -> Tuple[List[Entry], List[ZeroEntry]]:
    es: List[Entry] = []
    zs: List[ZeroEntry] = []
    es += backbone_entries("backbone2d", "backbone2d")
    es += backbone_entries("backbone_occ_pano", "backbone_occ_pano")
    es += initialization_entries()
    for i in range(3):
        e, z = spvcnn_entries(i)
        es += e
        zs += z
    e, z = gru_entries()
    es += e
    zs += z
    es += heads_entries()
    es += decoder_entries()
    return es, zs


SKIPPED_PREFIXES = (
    # dead code in the reference forward (see module docstring)
    "neucon_net.panoptic_feat_fusion.img2panoptic_0",
    "neucon_net.panoptic_feat_fusion.occ2panoptic_0",
    "neucon_net.panoptic_feat_fusion.pre_fusion",
    "neucon_net.criterion.",
)


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def _set_path(tree: Dict, path: Tuple[str, ...], value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def apply_entries(sd: Dict[str, np.ndarray], entries: List[Entry],
                  zeros: List[ZeroEntry] = (),
                  strict: bool = True,
                  transforms: Optional[Dict[str, Callable]] = None
                  ) -> Dict[str, Dict]:
    """Convert the given entry list from a torch state_dict into nested
    {'params', 'batch_stats', 'buffers'} trees.

    `transforms` overrides TRANSFORMS: tools/fingerprint.py uses it to try
    the other kernel-offset enumeration orders (layout auto-flip)."""
    if transforms is None:
        transforms = TRANSFORMS
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}, "buffers": {}}
    used = set()
    missing = []
    for e in entries:
        if e.src not in sd:
            missing.append(e.src)
            continue
        w = np.asarray(sd[e.src], np.float32)
        if tuple(w.shape) != e.src_shape:
            raise ValueError(f"{e.src}: shape {w.shape} != expected "
                             f"{e.src_shape}")
        used.add(e.src)
        if e.transform.startswith("inproj_w"):
            v = _t_lin(_split3(w, int(e.transform[-1])))
        elif e.transform.startswith("inproj_b"):
            v = _split3(w, int(e.transform[-1]))
        else:
            v = transforms[e.transform](w)
        _set_path(out[e.collection], e.dst, v)
    if missing and strict:
        raise KeyError(f"{len(missing)} reference keys missing, first 10: "
                       f"{missing[:10]}")
    for z in zeros:
        # bias of a bias-less torch module — find its kernel to size it
        node = out[z.collection]
        for k in z.dst[:-1]:
            node = node.get(k, {})
        kern = node.get("kernel")
        if kern is not None:
            node["bias"] = np.zeros((kern.shape[-1],), np.float32)
    out["_used_keys"] = used
    return out

def convert_reference_state_dict(sd: Dict[str, np.ndarray],
                                 strict: bool = True,
                                 transforms: Optional[Dict[str, Callable]] = None
                                 ) -> Dict[str, torch.Tensor]:
    """Reference state_dict (numpy values, 'module.' prefix stripped) ->
    {state_dict name: f32 tensor} of the port's EPRecon at the default
    config (the reference schema fixes the channel plan). The entries give
    the flax-layout tree of the JAX importer, and convert.tree_to_torch
    lays it out for the port. Every converted tensor must land on a port
    tensor of its shape; with `strict`, every reference key must be present
    and every port tensor covered."""
    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.convert import tree_to_torch
    from eprecon_tpu_torch.models.eprecon import EPRecon

    entries, zeros = all_entries()
    tree = apply_entries(sd, entries, zeros, strict=strict,
                         transforms=transforms)
    used = tree.pop("_used_keys")
    tree["params"] = fuse_zr_gates(tree["params"])
    unexpected = [k for k in sd
                  if k not in used
                  and not any(k.startswith(p) for p in SKIPPED_PREFIXES)
                  and k.endswith((".weight", ".bias", ".kernel",
                                  ".running_mean", ".running_var"))]
    if unexpected:
        print(f"note: {len(unexpected)} unmapped tensors (first 10): "
              f"{unexpected[:10]}")

    model = EPRecon(default_config().model)   # its structure and shapes
    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats", "buffers"):
        for name, value in tree_to_torch(model, tree[coll]).items():
            if tuple(value.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: converted {tuple(value.shape)} vs "
                                 f"port {tuple(state[name].shape)}")
            out[name] = value.contiguous()
    if strict:
        missing = [n for n in state if n not in out]
        if missing:
            raise KeyError(f"{len(missing)} port tensors not covered by the "
                           f"checkpoint, first 8: {missing[:8]}")
    return out


def random_state_dict(entries: List[Entry], seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Random torch-side state_dict with the schema the entries expect
    (shared-random-checkpoint testing; running_var kept positive)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for e in entries:
        if e.src in sd:
            continue
        if e.src.endswith("running_var"):
            sd[e.src] = rng.uniform(0.5, 1.5, e.src_shape).astype(np.float32)
        else:
            sd[e.src] = rng.normal(0, 0.1, e.src_shape).astype(np.float32)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a reference .ckpt ({"epoch", "model", "optimizer"}, reference
    main.py:343-348) with torch.load(weights_only=True) and return its
    model as a numpy state_dict, the DDP 'module.' prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--strict", action="store_true", default=True)
    ap.add_argument("--fingerprint", default=None, metavar="JSON",
                    help="activation fingerprint recorded in the reference "
                         "environment (tools_dev/record_reference_fingerprint"
                         ".py); verifies the kernel-enumeration layout and "
                         "auto-flips it on mismatch")
    ap.add_argument("--record_fingerprint", default=None, metavar="JSON",
                    help="write this checkpoint's fingerprint under the "
                         "(possibly auto-flipped) layout used")
    args = ap.parse_args(argv)

    from eprecon_tpu_torch.tools import fingerprint as fpmod

    sd = load_torch_checkpoint(args.torch_ckpt)
    layout = fpmod.DEFAULT_LAYOUT
    if args.fingerprint:
        t0 = time.perf_counter()
        layout, _ = fpmod.verify_or_fix_layout(
            sd, fpmod.load_fingerprint(args.fingerprint))
        print(f"fingerprint verified under layout {fpmod.layout_name(layout)} "
              f"in {time.perf_counter() - t0:.3f} s")
    if args.record_fingerprint:
        fpmod.save_fingerprint(fpmod.fingerprint_state_dict(sd, layout),
                               args.record_fingerprint)
    t0 = time.perf_counter()
    converted = convert_reference_state_dict(
        sd, strict=args.strict, transforms=fpmod.transforms_for(layout))
    seconds = time.perf_counter() - t0
    torch.save({"model": converted}, args.out)
    print(f"wrote {args.out}: {len(converted)} tensors (converted in "
          f"{seconds:.3f} s)")
    return converted


if __name__ == "__main__":
    main()
