"""The port's viewers against the JAX package's: the point-cloud exports of
`eprecon_tpu_torch/data/visualization.py` write the same PLY bytes as
eprecon_tpu/data/visualization.py for every colouring, and the headless
mesh viewer of `eprecon_tpu_torch/tools/render.py` draws the same PNG
pixels as eprecon_tpu/tools/render.py (a test that needs matplotlib skips
where it is absent)."""
import numpy as np
import pytest

from eprecon_tpu.data import visualization as jvis
from eprecon_tpu.tools import render as jrender
from eprecon_tpu_torch.data import visualization as tvis
from eprecon_tpu_torch.inference.mesh_export import tsdf_to_mesh, write_ply
from eprecon_tpu_torch.tools import render as trender

KINDS = {"xyz": None, "rgb": (0, 300), "tsdf": (-1.5, 1.5),
         "semantic": (0, 25), "instance": (0, 40)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pointcloud_ply_bytes_equal(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    xyz = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    span = KINDS[kind]
    values = None if span is None else rng.uniform(*span, (50, 3) if kind == "rgb"
                                                   else 50)
    if kind in ("semantic", "instance"):
        values = values.astype(np.int64)
    paths = [tmp_path / f"{side}.ply" for side in ("jax", "port")]
    jvis.visualize_points(xyz, values, kind, str(paths[0]))
    out = tvis.visualize_points(xyz, values, kind, str(paths[1]),
                                interactive=True)  # no pyvista: the PLY
    assert out == str(paths[1])
    assert paths[1].read_bytes() == paths[0].read_bytes()


def test_volume_export_bytes_equal(tmp_path):
    rng = np.random.default_rng(3)
    vol = rng.uniform(-1.2, 1.2, (6, 7, 5)).astype(np.float32)
    for kind, v in (("tsdf", vol), ("semantic", (vol * 10).astype(np.int32))):
        a = jvis.visualize_volume(v, kind, np.array([0.1, -0.2, 0.3]), 0.04,
                                  str(tmp_path / f"j_{kind}.ply"))
        b = tvis.visualize_volume(v, kind, np.array([0.1, -0.2, 0.3]), 0.04,
                                  str(tmp_path / f"t_{kind}.ply"))
        assert open(b, "rb").read() == open(a, "rb").read()
    with pytest.raises(ValueError, match="unknown kind"):
        tvis.colorize(np.zeros(3), "depth", 3)


def _sphere_mesh(path):
    g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
    tsdf = np.clip((np.linalg.norm(g - 5.5, axis=-1) - 4.0) / 2.0, -1, 1)
    verts, faces, _ = tsdf_to_mesh(tsdf.astype(np.float32), np.zeros(3), 0.1)
    colors = (np.abs(verts) * 400 % 255).astype(np.uint8)
    write_ply(str(path), verts, faces, colors)


def test_headless_render_pixels_equal(tmp_path, monkeypatch):
    """One snapshot of a mesh (`--once`) and one through `watch`, the same
    pixels from both packages."""
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg

    monkeypatch.delenv("DISPLAY", raising=False)
    meshes = tmp_path / "incremental"
    meshes.mkdir()
    _sphere_mesh(meshes / "mesh_0000.ply")
    snaps = {}
    for side, mod in (("jax", jrender), ("port", trender)):
        vis = mod.Visualizer(str(tmp_path / side))
        once = vis.vis_mesh(str(meshes / "mesh_0000.ply"))
        vis.close()
        assert mod.watch(str(meshes), str(tmp_path / f"{side}_watch"),
                         poll=0.0, max_updates=1) == 1
        snaps[side] = [mpimg.imread(once),
                       mpimg.imread(str(tmp_path / f"{side}_watch" /
                                        "view_0000.png"))]
    for got, want in zip(snaps["port"], snaps["jax"]):
        assert got.shape == want.shape and got.shape[0] > 100
        np.testing.assert_array_equal(got, want)
    assert snaps["port"][0].std() > 0  # something was drawn
