"""Mesh extraction + export on the host, numpy (own copy of
eprecon_tpu/inference/mesh_export.py).

Reference: utils.py:224-288 (tsdf2mesh / tsdf_panoptic2mesh via marching
cubes) and utils.py:318-388 (SaveScene incremental/eval export). Marching
cubes stays on host (skimage), as in the reference.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# 20-class color palette for panoptic meshes (stable hues per class)
_PALETTE = np.array([
    [200, 200, 200], [174, 199, 232], [152, 223, 138], [31, 119, 180],
    [255, 187, 120], [188, 189, 34], [140, 86, 75], [255, 152, 150],
    [214, 39, 40], [197, 176, 213], [148, 103, 189], [196, 156, 148],
    [23, 190, 207], [247, 182, 210], [219, 219, 141], [255, 127, 14],
    [158, 218, 229], [44, 160, 44], [112, 128, 144], [227, 119, 194],
    [82, 84, 163],
], np.uint8)


def marching_cubes(tsdf: np.ndarray, level: float = 0.0):
    """verts, faces, normals from a TSDF volume.

    Uses skimage's marching cubes when available; otherwise the built-in
    vectorized SurfaceNets extractor (surface_nets below) — same contract
    (verts in voxel units on the zero crossing, triangle faces, normals).
    """
    try:
        from skimage import measure

        verts, faces, norms, _ = measure.marching_cubes(tsdf, level=level)
        return verts, faces, norms
    except ImportError:
        return surface_nets(tsdf, level)


def surface_nets(tsdf: np.ndarray, level: float = 0.0):
    """Vectorized naive SurfaceNets isosurface extraction (numpy).

    One vertex per sign-change cell, placed at the mean of its edge
    crossings; one quad (two triangles) per sign-changing lattice edge,
    connecting the 4 cells around it, wound by the sign direction.
    Stands in for skimage.measure.marching_cubes where skimage is absent;
    vertices lie on the interpolated zero crossing within each cell, which
    is what the mesh metrics and viewers consume.
    Returns (verts [N,3] float voxel units, faces [M,3] int, normals [N,3]).
    """
    v = np.asarray(tsdf, np.float32) - level
    inside = v < 0
    if not inside.any() or inside.all():
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))
    nx, ny, nz = v.shape

    # --- cell vertices: mean of edge-crossing points over the cell's edges
    # accumulate crossing positions into the (up to 4) cells sharing an edge
    cell_sum = np.zeros((nx - 1, ny - 1, nz - 1, 3), np.float64)
    cell_cnt = np.zeros((nx - 1, ny - 1, nz - 1), np.int32)
    quads = []  # (corner cell index arrays, flip flags)

    for axis in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, -1)
        sl1[axis] = slice(1, None)
        a = v[tuple(sl0)]
        b = v[tuple(sl1)]
        cross = (a < 0) != (b < 0)
        idx = np.argwhere(cross)
        if len(idx) == 0:
            continue
        av = a[cross]
        bv = b[cross]
        t = av / (av - bv)  # interpolated crossing along the edge
        pos = idx.astype(np.float64)
        pos[:, axis] += t
        # the 4 cells sharing this edge differ in the two other axes
        o1, o2 = [ax for ax in range(3) if ax != axis]
        flip = bv < 0  # edge points from outside to inside → flip winding
        cells = []
        for d1 in (0, 1):
            for d2 in (0, 1):
                c = idx.copy()
                c[:, o1] -= d1
                c[:, o2] -= d2
                cells.append(c)
        ok4 = []
        for c in cells:
            ok = ((c >= 0).all(1) & (c[:, 0] < nx - 1) & (c[:, 1] < ny - 1)
                  & (c[:, 2] < nz - 1))
            ok4.append(ok)
            cc = c[ok]
            np.add.at(cell_sum, (cc[:, 0], cc[:, 1], cc[:, 2]), pos[ok])
            np.add.at(cell_cnt, (cc[:, 0], cc[:, 1], cc[:, 2]), 1)
        # quads only where all 4 cells are in bounds
        all_ok = ok4[0] & ok4[1] & ok4[2] & ok4[3]
        quads.append((tuple(c[all_ok] for c in cells), flip[all_ok]))

    active = cell_cnt > 0
    vert_id = np.full(active.shape, -1, np.int64)
    vert_id[active] = np.arange(int(active.sum()))
    verts = (cell_sum[active] / cell_cnt[active][:, None]).astype(np.float32)

    faces = []
    for (c00, c01, c10, c11), flip in quads:
        i00 = vert_id[c00[:, 0], c00[:, 1], c00[:, 2]]
        i01 = vert_id[c01[:, 0], c01[:, 1], c01[:, 2]]
        i10 = vert_id[c10[:, 0], c10[:, 1], c10[:, 2]]
        i11 = vert_id[c11[:, 0], c11[:, 1], c11[:, 2]]
        # quad (i00, i01, i11, i10) split into two triangles; flip winding
        # where the edge crosses inside→outside
        t1 = np.where(flip[:, None], np.stack([i00, i01, i11], 1),
                      np.stack([i00, i11, i01], 1))
        t2 = np.where(flip[:, None], np.stack([i00, i11, i10], 1),
                      np.stack([i00, i10, i11], 1))
        faces.append(t1)
        faces.append(t2)
    faces = (np.concatenate(faces) if faces else np.zeros((0, 3), np.int64))

    # vertex normals from the TSDF gradient (central differences)
    gx, gy, gz = np.gradient(v)
    vi = np.clip(np.round(verts).astype(int), 0, np.array(v.shape) - 1)
    n = np.stack([gx[vi[:, 0], vi[:, 1], vi[:, 2]],
                  gy[vi[:, 0], vi[:, 1], vi[:, 2]],
                  gz[vi[:, 0], vi[:, 1], vi[:, 2]]], 1)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    return verts, faces, n.astype(np.float32)


def tsdf_to_mesh(tsdf: np.ndarray, origin: np.ndarray, voxel_size: float):
    """World-space mesh from a dense TSDF (reference utils.py:224-230)."""
    verts, faces, norms = marching_cubes(tsdf)
    verts = verts * voxel_size + origin[None, :]
    return verts, faces, norms


def panoptic_vertex_colors(verts_vox: np.ndarray, labels: np.ndarray,
                           kind: str = "semantic") -> np.ndarray:
    """Color mesh vertices by nearest-voxel semantic/instance label
    (reference utils.py:232-288 tsdf_panoptic2mesh)."""
    idx = np.clip(np.round(verts_vox).astype(int), 0,
                  np.array(labels.shape) - 1)
    lab = labels[idx[:, 0], idx[:, 1], idx[:, 2]]
    if kind == "semantic":
        return _PALETTE[np.clip(lab, 0, len(_PALETTE) - 1)]
    # instance: hash ids to palette
    h = (lab.astype(np.int64) * 2654435761) % (len(_PALETTE) - 1)
    return _PALETTE[1 + h.astype(int)]


def _write_rows(f, fmt: str, rows: np.ndarray, chunk: int = 65536):
    """Write `rows` (2D) as text, one `fmt` line per row: the % formatting
    of Python's own float and int, applied to a chunk of rows at once."""
    for i in range(0, len(rows), chunk):
        block = rows[i:i + chunk]
        f.write((fmt * len(block)) % tuple(block.ravel().tolist()))


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Minimal ASCII PLY writer (reference fusion.py meshwrite): vertices
    with 4 decimals, optional uint8 colours, triangle faces."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        xyz = np.asarray(verts)[:, :3].astype(np.float64)
        if colors is not None:
            rows = np.concatenate([xyz, np.asarray(colors)[:, :3].astype(np.float64)], 1)
            _write_rows(f, "%.4f %.4f %.4f %d %d %d\n", rows)
        else:
            _write_rows(f, "%.4f %.4f %.4f\n", xyz)
        _write_rows(f, "3 %d %d %d\n", np.asarray(faces)[:, :3].astype(np.int64))


def save_scene(result, out_dir: str, save_mesh: bool = True,
               save_npz: bool = True):
    """Persist a finished scene (reference utils.py:362-388 save_scene_eval):
    .npz volumes + plain/semantic/instance-colored meshes."""
    os.makedirs(out_dir, exist_ok=True)
    if save_npz:
        np.savez_compressed(
            os.path.join(out_dir, f"{result.name}.npz"),
            origin=result.origin, voxel_size=result.voxel_size,
            tsdf=result.tsdf, instance=result.instance,
            semantic=result.semantic)
    if save_mesh and (np.abs(result.tsdf) < 1).any():
        verts_vox, faces, _ = marching_cubes(result.tsdf)
        verts = verts_vox * result.voxel_size + result.origin[None, :]
        write_ply(os.path.join(out_dir, f"{result.name}.ply"), verts, faces)
        sem_c = panoptic_vertex_colors(verts_vox, result.semantic, "semantic")
        write_ply(os.path.join(out_dir, f"{result.name}_semantic.ply"),
                  verts, faces, sem_c)
        ins_c = panoptic_vertex_colors(verts_vox, result.instance, "instance")
        write_ply(os.path.join(out_dir, f"{result.name}_instance.ply"),
                  verts, faces, ins_c)
