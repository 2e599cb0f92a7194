"""Load flax variable trees (as numpy arrays) into the port's modules.

The port's submodules carry the flax module names, so a tree path is an
attribute path. Leaves change layout by module type:
  * Conv kernel [*k, Cin/g, Cout] -> weight [Cout, Cin/g, *k]
  * ConvTranspose kernel [*k, Cin, Cout] -> weight [Cin, Cout, *k] with the
    spatial taps flipped (flax's transpose conv does not flip its kernel)
  * Dense kernel [in, out] -> Linear weight [out, in]
  * norm 'scale' -> weight; batch_stats 'mean' / 'var' -> running stats
  * the fused z/r GRU gate is one conv in both, so it keeps its layout;
  * a sparse conv's kernel [O, Cin, Cout] keeps flax's layout (modules
    with `flax_kernel_layout`, models/spvcnn.py).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from eprecon_tpu_torch.models.layers import Conv, Dense

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaf_to_torch(module: nn.Module, name: str, value: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if name != "kernel" or getattr(module, "flax_kernel_layout", False):
        return t
    if isinstance(module, Dense):
        return t.T
    if isinstance(module, Conv):
        nd = module.nd
        if module.transpose:
            return t.flip(list(range(nd))).permute(nd, nd + 1, *range(nd))
        return t.permute(nd + 1, nd, *range(nd))
    raise TypeError(f"'kernel' under {type(module).__name__}")


def _walk(module: nn.Module, tree: Mapping, path: str, prefix: str,
          out: Dict[str, torch.Tensor]):
    for key, value in tree.items():
        where = f"{path}/{key}"
        if isinstance(value, Mapping):
            if not hasattr(module, key):
                raise KeyError(f"no port module for flax path {where}")
            _walk(getattr(module, key), value, where, f"{prefix}{key}.", out)
            continue
        attr = "weight" if key == "kernel" else _RENAME.get(key, key)
        if not isinstance(getattr(module, attr, None), torch.Tensor):
            raise KeyError(f"no port tensor for flax leaf {where}")
        out[prefix + attr] = _leaf_to_torch(module, key, value)


def tree_to_torch(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax tree of numpy leaves (parameters, batch statistics, or any
    tree of the same layout, such as gradients) as {state_dict name of
    `module`: tensor in the port's layout}. Copies nothing into `module`."""
    out: Dict[str, torch.Tensor] = {}
    _walk(module, tree, "", "", out)
    return out


def variables_to_torch(module: nn.Module, params: Mapping,
                       batch_stats: Optional[Mapping] = None,
                       buffers: Optional[Mapping] = None,
                       strict: bool = True) -> nn.Module:
    """Copy a flax variables tree (params, batch_stats and the 'buffers'
    collection, numpy leaves) into `module`, whose structure mirrors the
    flax module's. With `strict`, every parameter and persistent buffer of
    `module` must be covered by the tree. Returns `module`."""
    state = module.state_dict(keep_vars=True)
    loaded = set()
    for tree in (params, batch_stats or {}, buffers or {}):
        for name, new in tree_to_torch(module, tree).items():
            target = state[name]
            if new.shape != target.shape:
                raise ValueError(f"{name}: flax {tuple(new.shape)} vs port "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(new)
            loaded.add(name)
    if strict:
        missing = [n for n in state if n not in loaded]
        if missing:
            raise KeyError(f"port tensors not in the flax tree: {missing[:8]}"
                           f"{' ...' if len(missing) > 8 else ''}")
    return module
