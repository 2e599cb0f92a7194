"""ImageNet warm start of the MnasMulti backbones: torchvision MNASNet-1.0
weights -> the port's MnasMulti trunk tensors (own copy of
eprecon_tpu/tools/import_backbone_weights.py).

The reference initializes both of its backbones from ImageNet-pretrained
torchvision MNASNet (reference models/backbone.py:28). This tool converts
a local torchvision `mnasnet1_0` state_dict (.pth; keys `layers.N...`),
or a reference EPRecon checkpoint's `backbone2d` / `backbone_occ_pano`
subtree (`--prefix backbone2d`: the trunk and the FPN convs, through the
reference importer's entries), into {MnasMulti state_dict name: tensor}.
The arrays are first laid out as the JAX package's flax tree and then go
through convert.tree_to_torch, so the result is by construction the JAX
tool followed by the port's flax converter.

Usage:
  python -m eprecon_tpu_torch.tools.import_backbone_weights \\
      --torch_ckpt mnasnet1.0_top1_73.512-f206786ef8.pth --out backbone.pt

The output is {"model": {"backbone2d.<name>": ..., "backbone_occ_pano.<name>":
...}}: train/checkpoint.restore_submodule(path, model, "backbone2d") (and
"backbone_occ_pano") warm-starts each backbone and touches nothing else.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

BACKBONES = ("backbone2d", "backbone_occ_pano")


def _conv(w) -> np.ndarray:
    """torch [out, in/groups, kh, kw] -> flax [kh, kw, in/groups, out]."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _bn(prefix: str, sd) -> Tuple[Dict, Dict]:
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def convert_mnasnet(sd, prefix: str = "layers") -> Tuple[Dict, Dict]:
    """torchvision mnasnet1_0 state_dict -> (params, batch_stats) flax-layout
    trees of MnasMulti (trunk only; the FPN convs are new)."""
    params: Dict = {}
    stats: Dict = {}

    def put(flax_name, conv_key, bn_key=None):
        params[flax_name] = {"kernel": _conv(sd[conv_key])}
        if bn_key:
            bnp, bns = _bn(bn_key, sd)
            n = flax_name.replace("Conv", "BatchNorm")
            params[n] = bnp
            stats[n] = bns

    # stem: layers 0/1, 3/4, 6/7 (reference backbone.py:32-42 conv0 head)
    put("Conv_0", f"{prefix}.0.weight", f"{prefix}.1")
    put("Conv_1", f"{prefix}.3.weight", f"{prefix}.4")
    put("Conv_2", f"{prefix}.6.weight", f"{prefix}.7")

    # stacks 8, 9, 10 -> MBStack_0..2 with InvertedResidual_0..2
    for si, layer in enumerate((8, 9, 10)):
        stack: Dict = {}
        sstats: Dict = {}
        for bi in range(3):
            blk: Dict = {}
            bstats: Dict = {}
            base = f"{prefix}.{layer}.{bi}.layers"
            for ci, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4), (6, 7))):
                blk[f"Conv_{ci}"] = {"kernel": _conv(sd[f"{base}.{conv_idx}.weight"])}
                bnp, bns = _bn(f"{base}.{bn_idx}", sd)
                blk[f"BatchNorm_{ci}"] = bnp
                bstats[f"BatchNorm_{ci}"] = bns
            stack[f"InvertedResidual_{bi}"] = blk
            sstats[f"InvertedResidual_{bi}"] = bstats
        params[f"MBStack_{si}"] = stack
        stats[f"MBStack_{si}"] = sstats
    return params, stats


def convert_backbone(sd, prefix: str = "layers") -> Dict[str, torch.Tensor]:
    """A torchvision mnasnet1_0 state_dict (prefix `layers`), or a reference
    checkpoint's model with `prefix` one of BACKBONES (numpy or tensor
    values, 'module.' stripped) -> {MnasMulti state_dict name: f32 tensor}."""
    from eprecon_tpu_torch.convert import tree_to_torch
    from eprecon_tpu_torch.models.backbone import MnasMulti

    if prefix in BACKBONES:
        from eprecon_tpu_torch.tools import import_reference_weights as irw

        tree = irw.apply_entries({k: np.asarray(v) for k, v in sd.items()},
                                 irw.backbone_entries(prefix, prefix))
        params, stats = tree["params"][prefix], tree["batch_stats"][prefix]
    else:
        params, stats = convert_mnasnet(sd, prefix)
    trunk = MnasMulti()   # its structure and shapes
    state = trunk.state_dict()
    out = {}
    for tree in (params, stats):
        for name, value in tree_to_torch(trunk, tree).items():
            if tuple(value.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: converted {tuple(value.shape)} vs "
                                 f"MnasMulti {tuple(state[name].shape)}")
            out[name] = value.contiguous()
    return out


def merge_into_backbone(model: nn.Module, converted: Dict[str, torch.Tensor],
                        backbone_name: str) -> nn.Module:
    """Copy converted trunk tensors into `model.<backbone_name>` in place;
    nothing else of `model` changes. Returns `model`."""
    state = getattr(model, backbone_name).state_dict()
    for name, value in converted.items():
        if name not in state:
            raise KeyError(f"no tensor {backbone_name}.{name} in the model")
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{backbone_name}.{name}: converted "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(state[name].shape)}")
    with torch.no_grad():
        for name, value in converted.items():
            state[name].copy_(value)
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prefix", default="layers",
                    help="'layers' for a torchvision state_dict, or "
                         "backbone2d / backbone_occ_pano for that subtree of "
                         "a reference checkpoint")
    args = ap.parse_args(argv)

    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd.get("state_dict", sd))
    sd = {k[len("module."):] if k.startswith("module.") else k: v.numpy()
          for k, v in sd.items() if isinstance(v, torch.Tensor)}
    converted = convert_backbone(sd, args.prefix)
    torch.save({"model": {f"{b}.{k}": v for b in BACKBONES
                          for k, v in converted.items()}}, args.out)
    print(f"wrote {args.out}: {len(converted)} tensors for each of "
          f"{', '.join(BACKBONES)}")
    return converted


if __name__ == "__main__":
    main()
