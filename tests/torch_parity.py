"""Shared helpers for the JAX -> PyTorch parity tests (tests/test_torch_*.py).

A flax module is initialised, its variables are carried into the port's
module by eprecon_tpu_torch.convert, and both run on the same numpy
inputs made from a seed.
"""
import dataclasses

import jax
import numpy as np
import torch

from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.convert import variables_to_torch


def to_np(tree):
    """jax tree -> numpy tree (bf16 widened to f32)."""
    def leaf(x):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, tree)


def load(port_module, variables):
    v = to_np(variables)
    return variables_to_torch(port_module, v.get("params", {}),
                              v.get("batch_stats"), v.get("buffers"))


def t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    return to_np(x)


def assert_rel(got, want, tol, name=""):
    """max |got - want| <= tol * max |want| (tolerance relative to the
    tensor's scale: bf16 rounding errors scale with the values)."""
    g, w = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
    assert np.isfinite(g).all(), f"{name}: non-finite values"
    scale = max(np.abs(w).max(), 1e-6)
    err = np.abs(g - w).max() / scale
    assert err <= tol, f"{name}: max rel err {err:.3g} > {tol}"


def port_model_config(jcfg):
    """eprecon_tpu ModelConfig -> eprecon_tpu_torch ModelConfig (the
    fields the port keeps)."""
    def conv(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            val = getattr(src, f.name)
            if dataclasses.is_dataclass(val):
                val = conv(type(getattr(cls(), f.name)), val)
            kw[f.name] = val
        return cls(**kw)
    return conv(tconfig.ModelConfig, jcfg)


def random_variables(flax_module, *args, seed=0):
    """A full random flax variables tree (numpy) for `flax_module` applied
    to `args`, filled from a seed without running its init (tracing the
    init for shapes is much cheaper than compiling it on the CPU)."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        coll = str(getattr(path[0], "key", path[0]))
        shape = leaf.shape
        if coll == "batch_stats":
            x = (0.1 * rng.standard_normal(shape) if name == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = rng.uniform(0.8, 1.2, shape)
        elif name == "bias":
            x = 0.05 * rng.standard_normal(shape)
        else:  # learned queries / embeddings, fourier projection
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
