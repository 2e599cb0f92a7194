"""Shared helpers for the JAX -> PyTorch parity tests (tests/test_torch_*.py).

A flax module is initialised, its variables are carried into the port's
module by eprecon_tpu_torch.convert, and both run on the same numpy
inputs made from a seed.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import torch

from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.convert import variables_to_torch

# writers of a ScanNet download's formats (.sens, binary PLY, segs and
# aggregation json, label tsv), the torchvision MNASNet schema and the
# reference's checkpoint format: one copy, beside the card check that
# packs a raw scan from the port's tree with them
from chip_smoke import (SYNTHETIC_CATEGORIES, mnasnet1_0_schema,  # noqa: F401
                        pack_scene_sens, random_mnasnet_state_dict,
                        scannet_renumbered, write_label_tsv, write_ply_binary,
                        write_reference_checkpoint, write_scannet_annotations,
                        write_sens)


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


ROUNDING_MARGIN = 1e-4  # px from a half-integer, in float64


def on_rounding_boundary(origin, poses, intrinsics, dim, voxel_size):
    """[dim] bool: voxels whose pixel coordinate lies within ROUNDING_MARGIN
    of a half-integer in some view, in float64. TSDF fusion rounds that
    coordinate to the nearest depth pixel in f32, where XLA-CPU and torch
    may order the 3x3 product world @ R.T differently and so land on either
    side (ROADMAP.md section 3, geometry on the boundary): such a voxel
    reads a neighbouring depth pixel on one side only."""
    ijk = np.stack(np.meshgrid(*[np.arange(n) for n in dim], indexing="ij"), -1)
    world = np.asarray(origin, np.float64) + voxel_size * ijk
    near = np.zeros(dim, bool)
    for pose, k in zip(np.asarray(poses, np.float64),
                       np.asarray(intrinsics, np.float64)):
        w2c = np.linalg.inv(pose)
        cam = world @ w2c[:3, :3].T + w2c[:3, 3]
        for axis, f, c in ((0, k[0, 0], k[0, 2]), (1, k[1, 1], k[1, 2])):
            pix = cam[..., axis] * f / cam[..., 2] + c
            near |= np.abs(pix - np.floor(pix) - 0.5) < ROUNDING_MARGIN
    return near


def assert_exemption_caps(exempt):
    """Caps on the voxels a GT comparison exempts, per pyramid level
    (finest first): under 1% of all levels' voxels and of each finer
    level; at most one voxel column at the coarsest."""
    n_exempt, total = 0, 0
    for lvl, mask in enumerate(exempt):
        if lvl < len(exempt) - 1:
            assert mask.mean() <= 0.01, (lvl, int(mask.sum()))
        else:
            columns = {(x, y) for x, y, _ in np.argwhere(mask)}
            assert len(columns) <= 1, (lvl, columns)
        n_exempt, total = n_exempt + int(mask.sum()), total + mask.size
    assert n_exempt <= 0.01 * total, n_exempt


def rounding_boundary_levels(origin, poses, intrinsics, dims, voxel_size):
    """`on_rounding_boundary` per pyramid level (finest first, voxel size
    doubling)."""
    return [on_rounding_boundary(origin, poses, intrinsics, tuple(dim),
                                 voxel_size * 2 ** lvl)
            for lvl, dim in enumerate(dims)]


def rounding_keep_masks(origin, poses, intrinsics, dims, voxel_size):
    """Per pyramid level, the voxels a GT comparison holds exactly: all but
    those on a rounding boundary, under `assert_exemption_caps`."""
    near = rounding_boundary_levels(origin, poses, intrinsics, dims,
                                    voxel_size)
    assert_exemption_caps(near)
    return [~m for m in near]


def write_scannet_fixture(root):
    """The JAX tools' on-disk ScanNet-layout tree under `root`
    (tests/test_scannet_disk.py's fixture): 2 scenes of 20 frames at
    120x160 (4 fragments of 9 keyframes per split), GT volumes and label
    volumes at 0.24 m under root/all_tsdf_9, and scans_test linked to
    scans."""
    import os

    from eprecon_tpu.tools.generate_gt import generate_all
    from eprecon_tpu.tools.make_synthetic_scannet import write_scene

    scans = os.path.join(root, "scans")
    labels = os.path.join(root, "labels")
    for s in range(2):
        write_scene(scans, labels, f"scene{s:04d}_00", seed=s, n_frames=20,
                    image_hw=(120, 160))
    os.symlink(scans, os.path.join(root, "scans_test"))
    generate_all(scans, save_name="all_tsdf_9", voxel_size=0.24, n_views=9,
                 label_path=labels)
    return root



@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU ops on one thread for the block. The suite runs
    several test processes side by side; torch's default of one thread
    per core made a micro-config training step burn 5.8 CPU-seconds for
    0.76 s of wall time (0.87 on one thread), starving the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
