"""Load flax variable trees (as numpy arrays) into the port's modules.

The port's submodules carry the flax module names, so a tree path is an
attribute path. Leaves change layout by module type:
  * Conv kernel [*k, Cin/g, Cout] -> weight [Cout, Cin/g, *k]
  * ConvTranspose kernel [*k, Cin, Cout] -> weight [Cin, Cout, *k] with the
    spatial taps flipped (flax's transpose conv does not flip its kernel)
  * Dense kernel [in, out] -> Linear weight [out, in]
  * norm 'scale' -> weight; batch_stats 'mean' / 'var' -> running stats
  * the fused z/r GRU gate is one conv in both, so it keeps its layout.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from eprecon_tpu_torch.models.layers import Conv, Dense

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaf_to_torch(module: nn.Module, name: str, value: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if name != "kernel":
        return t
    if isinstance(module, Dense):
        return t.T
    if isinstance(module, Conv):
        nd = module.nd
        if module.transpose:
            return t.flip(list(range(nd))).permute(nd, nd + 1, *range(nd))
        return t.permute(nd + 1, nd, *range(nd))
    raise TypeError(f"'kernel' under {type(module).__name__}")


def _load(module: nn.Module, tree: Mapping, path: str, loaded: set):
    for key, value in tree.items():
        where = f"{path}/{key}"
        if isinstance(value, Mapping):
            if not hasattr(module, key):
                raise KeyError(f"no port module for flax path {where}")
            _load(getattr(module, key), value, where, loaded)
            continue
        attr = "weight" if key == "kernel" else _RENAME.get(key, key)
        target = getattr(module, attr, None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"no port tensor for flax leaf {where}")
        new = _leaf_to_torch(module, key, value)
        if new.shape != target.shape:
            raise ValueError(f"{where}: flax {tuple(new.shape)} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(new)
        loaded.add(id(target))


def variables_to_torch(module: nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None,
                       buffers: Optional[Mapping] = None,
                       strict: bool = True) -> nn.Module:
    """Copy a flax variables tree (params, batch_stats and the 'buffers'
    collection, numpy leaves) into `module`, whose structure mirrors the
    flax module's. With `strict`, every parameter and persistent buffer of
    `module` must be covered by the tree. Returns `module`."""
    loaded: set = set()
    for tree in (params, batch_stats or {}, buffers or {}):
        _load(module, tree, "", loaded)
    if strict:
        missing = [n for n, t in module.state_dict(keep_vars=True).items()
                   if id(t) not in loaded]
        if missing:
            raise KeyError(f"port tensors not in the flax tree: {missing[:8]}"
                           f"{' ...' if len(missing) > 8 else ''}")
    return module
