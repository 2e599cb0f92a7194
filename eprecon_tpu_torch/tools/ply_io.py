"""Minimal PLY reading (own copy of eprecon_tpu/tools/ply_io.py): vertices
from ascii and binary_little_endian files, whole meshes from ascii ones."""
from __future__ import annotations

import numpy as np


def read_ply_vertices(path: str) -> np.ndarray:
    """Vertex xyz from a PLY file (enough for mesh metrics)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = 0
        props = []
        fmt = "ascii"
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))

        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4",
                    "short": "i2", "ushort": "u2", "char": "i1"}
        if fmt == "ascii":
            rows = []
            for _ in range(n_verts):
                rows.append([float(v) for v in f.readline().split()[:3]])
            return np.asarray(rows, np.float32)
        dtype = np.dtype([(name, type_map[t]) for t, name in props])
        data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype,
                             count=n_verts)
        return np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)


def read_ply_mesh(path: str):
    """(verts [N,3] f32, faces [M,3] i32, colors [N,3] u8 or None) from an
    ascii PLY (inference/mesh_export.write_ply emits ascii)."""
    with open(path, "rb") as f:
        n_verts = n_faces = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            parts = line.split()
            if parts and parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_verts = int(parts[2])
                elif parts[1] == "face":
                    n_faces = int(parts[2])
            elif parts and parts[0] == "property" and in_vertex:
                props.append(parts[2])
            if line == "end_header":
                break
        has_color = "red" in props
        verts = np.empty((n_verts, 3), np.float32)
        colors = np.empty((n_verts, 3), np.uint8) if has_color else None
        for i in range(n_verts):
            vals = f.readline().split()
            verts[i] = [float(v) for v in vals[:3]]
            if has_color:
                colors[i] = [int(v) for v in vals[3:6]]
        faces = np.empty((n_faces, 3), np.int32)
        for i in range(n_faces):
            vals = f.readline().split()
            faces[i] = [int(v) for v in vals[1:4]]
    return verts, faces, colors
