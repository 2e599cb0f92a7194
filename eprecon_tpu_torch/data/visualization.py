"""Point-cloud and voxel visualisation exports (port of
eprecon_tpu/data/visualization.py; reference datasets/visualization.py:
24-186, interactive pyvista viewers of xyz / rgb / semantic / instance /
tsdf point clouds).

The views are written as coloured ASCII PLY point clouds, which any viewer
opens; with `interactive=True` pyvista shows them where it is installed
(imported only then). The palette is the mesh export's.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from eprecon_tpu_torch.inference.mesh_export import _PALETTE


def _tsdf_colormap(values: np.ndarray) -> np.ndarray:
    """Blue (−1) → white (0) → red (+1)."""
    v = np.clip(values, -1, 1)
    r = np.clip(1 + v, 0, 1)
    b = np.clip(1 - v, 0, 1)
    g = 1 - np.abs(v)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def colorize(values: Optional[np.ndarray], kind: str, n: int) -> np.ndarray:
    if values is None or kind == "xyz":
        return np.full((n, 3), 180, np.uint8)
    if kind == "rgb":
        return np.clip(values, 0, 255).astype(np.uint8)
    if kind == "tsdf":
        return _tsdf_colormap(np.asarray(values, np.float32))
    if kind == "semantic":
        ids = np.clip(values.astype(int), 0, len(_PALETTE) - 1)
        return _PALETTE[ids]
    if kind == "instance":
        ids = values.astype(np.int64)
        return _PALETTE[1 + (ids * 2654435761 % (len(_PALETTE) - 1)).astype(int)]
    raise ValueError(f"unknown kind {kind!r}")


def write_pointcloud_ply(path: str, xyz: np.ndarray, colors: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(xyz, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def visualize_points(xyz: np.ndarray, values: Optional[np.ndarray] = None,
                     kind: str = "xyz", out_path: Optional[str] = None,
                     interactive: bool = False):
    """Export (or show) a labeled point cloud
    (reference datasets/visualization.py visualize_mesh)."""
    colors = colorize(values, kind, len(xyz))
    if interactive:
        try:
            import pyvista as pv

            cloud = pv.PolyData(np.asarray(xyz, np.float64))
            cloud["colors"] = colors
            cloud.plot(scalars="colors", rgb=True, point_size=5)
            return None
        except ImportError:
            pass
    out_path = out_path or f"viz_{kind}.ply"
    write_pointcloud_ply(out_path, xyz, colors)
    return out_path


def visualize_volume(volume: np.ndarray, values_kind: str = "tsdf",
                     origin=np.zeros(3), voxel_size: float = 1.0,
                     out_path: Optional[str] = None, threshold: float = 1.0):
    """Dense volume → occupied-voxel point cloud export."""
    if values_kind == "tsdf":
        sel = np.abs(volume) < threshold
    else:
        sel = volume > 0
    idx = np.argwhere(sel)
    xyz = idx * voxel_size + np.asarray(origin)
    return visualize_points(xyz, volume[sel], values_kind, out_path)
