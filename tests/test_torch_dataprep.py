"""The port's data preparation against the JAX package: the native
fragment loader and image codecs (csrc/fragment_loader.cpp,
data/native_loader.py), the decode-ahead prefetcher, the synthetic
ScanNet-layout writer, the GT generator and the depth protocol
(render_tsdf_depth, evaluate_scene, the evaluation CLI), on the JAX tools'
on-disk fixture (`torch_parity.write_scannet_fixture`: 2 scenes of 20
frames at 120x160, GT at 0.24 m); and the whole preparation path with
cv2 and PIL made unimportable.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_exemption_caps, one_torch_thread,
                          rounding_boundary_levels, write_scannet_fixture)

from eprecon_tpu.data.native_loader import NativeFragmentLoader as JaxLoader
from eprecon_tpu.tools import evaluation as jeval
from eprecon_tpu.tools import make_synthetic_scannet as jmake
from eprecon_tpu.tools.simple_loader import ScanNetSceneLoader as JaxSceneLoader
from eprecon_tpu_torch import kernels
from eprecon_tpu_torch import main as tmain
from eprecon_tpu_torch.config import load_config
from eprecon_tpu_torch.data import native_loader as nl
from eprecon_tpu_torch.data.prefetch import FragmentPrefetcher
from eprecon_tpu_torch.tools import evaluation as teval
from eprecon_tpu_torch.tools import generate_gt as tgt
from eprecon_tpu_torch.tools import make_synthetic_scannet as tmake

REPO = Path(__file__).resolve().parents[1]
SCENES = ("scene0000_00", "scene0001_00")
TSDF_TOL = 1e-5      # f32 fusion, as tests/test_torch_data.py
DEPTH_TOL = 1e-4     # m: f32 ray march, XLA and torch order the 3x3 products differently
METRIC_TOL = 1e-4    # depth and mesh metrics of renders within DEPTH_TOL
JPEG_MEAN_TOL = 1.0  # grey levels: another libjpeg build may round its IDCT differently


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_scannet_fixture(tmp_path_factory.mktemp("synthscan"))


@pytest.fixture(scope="module")
def scannet_frame(tmp_path_factory):
    """One frame at ScanNet's resolutions, written by cv2: color 1296x968
    (a smooth pattern with noise, as a photo has) and depth 640x480 in mm,
    some beyond 3 m."""
    d = tmp_path_factory.mktemp("frame")
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:968, 0:1296]
    base = np.stack([x * 0.15, y * 0.2, (x + y) * 0.08], -1) % 255
    color = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    depth = rng.integers(0, 4500, (480, 640)).astype(np.uint16)
    cv2.imwrite(str(d / "0.jpg"), color)
    cv2.imwrite(str(d / "0.png"), depth)
    return d / "0.jpg", d / "0.png", color, depth


def test_native_loader_matches_jax(root, scannet_frame):
    """NativeFragmentLoader, port and JAX (runtime/libfragment_loader.so,
    the same decoder, pad and resizes), bit for bit: every fragment of the
    fixture (120x160 frames upscaled to 640x480) and one fragment of 9
    views at ScanNet's resolutions (color padded 968 -> 972 and halved,
    depth 640x480 with values beyond 3 m zeroed)."""
    ds = tmain.build_dataset(load_config(None, [("train.path", str(root))]),
                             "train", device="cpu")
    jpg, png = (str(p) for p in scannet_frame[:2])
    fragments = [ds.image_paths(i) for i in range(len(ds))] + [([jpg] * 9, [png] * 9)]
    port, ref = nl.NativeFragmentLoader(4), JaxLoader(4)
    assert ref.native
    try:
        for imgs, depths in fragments:
            got = port.fetch(port.submit(imgs, depths), len(imgs))
            want = ref.fetch(ref.submit(imgs, depths), len(imgs))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert (got[1] == 0).any() and got[1].max() <= 3.0
        with pytest.raises(IOError, match="rc=-2"):
            port.fetch(port.submit([jpg, str(root / "missing.jpg")], [png, png]), 2)
    finally:
        port.close()
        ref.close()


def test_decoders_and_writers_match_cv2(scannet_frame, tmp_path):
    """The single-image codecs against cv2: PNG depth exact (mm / 1000,
    beyond max_depth zeroed), JPEG within a mean of 1 grey level (0 where
    both use one libjpeg), sizes from the headers; what the writers write
    cv2 reads back (PNG exact, JPEG as cv2's own file within a mean of 1)."""
    jpg, png, color, depth = scannet_frame
    want = cv2.imread(str(jpg)).astype(np.float32)
    got = nl.decode_jpeg(str(jpg))
    assert got.shape == want.shape == (968, 1296, 3)
    assert np.abs(got - want).mean() <= JPEG_MEAN_TOL
    assert nl.jpeg_size(str(jpg)) == (968, 1296) and nl.png_size(str(png)) == (480, 640)
    d = cv2.imread(str(png), cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
    np.testing.assert_array_equal(nl.decode_png_depth(str(png)), d)
    d[d > 3.0] = 0.0
    np.testing.assert_array_equal(nl.decode_png_depth(str(png), 3.0), d)

    nl.write_png16(str(tmp_path / "d.png"), depth)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED), depth)
    nl.write_jpeg(str(tmp_path / "c.jpg"), color)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), color)
    ours = cv2.imread(str(tmp_path / "c.jpg")).astype(np.float32)
    theirs = cv2.imread(str(tmp_path / "cv2.jpg")).astype(np.float32)
    assert np.abs(ours - theirs).mean() <= JPEG_MEAN_TOL
    with pytest.raises(IOError):
        nl.decode_jpeg(str(png))
    with pytest.raises(IOError):
        nl.decode_png_depth(str(jpg))


def test_route_and_build_errors(monkeypatch, tmp_path):
    """image_route picks libjpeg where its header and library exist, else
    nvJPEG, and names what is missing otherwise; a failed build raises with
    the compiler's own output (no fallback decoder)."""
    found = dict.fromkeys(["jpeglib.h", "libjpeg.so", "zlib.h", "libz.so",
                           "nvjpeg.h", "libnvjpeg.so"], "x")
    assert nl.image_route(found) == "libjpeg"
    assert nl.image_route(dict(found, **{"jpeglib.h": None})) == "nvjpeg"
    with pytest.raises(RuntimeError, match="no JPEG codec"):
        nl.image_route(dict(found, **{"libjpeg.so": None, "nvjpeg.h": None}))
    with pytest.raises(RuntimeError, match="no zlib"):
        nl.image_route(dict(found, **{"libz.so": None}))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "HOST_FLAGS", (*kernels.HOST_FLAGS,
                                                "-DFRAG_NO_SUCH=1", "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        nl.NativeFragmentLoader(1)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_prefetcher_matches_getitem(root, mode):
    """FragmentPrefetcher over every fragment against the synchronous
    dataset[i] (both decode with the port's library): images bit for bit
    (the transforms' resize repeats the loader's arithmetic), cameras and
    projections exact; the GT occupancy within JAX's tolerance (IoU > 0.8:
    the prefetcher's depth is resized to 640x480, the synchronous one keeps
    the fixture's 160x120, tests/test_scannet_disk.py)."""
    cfg = load_config(None, [("model.n_vox", (16, 16, 16)),
                             ("model.voxel_size", 0.24),
                             ("train.path", str(root)), ("test.path", str(root))])
    ds = tmain.build_dataset(cfg, mode, device="cpu")
    pf = FragmentPrefetcher(ds, n_threads=2)
    try:
        got_all = list(pf.iterate(range(len(ds))))
    finally:
        pf.close()
    assert len(got_all) == len(ds) == 4
    for i, got in enumerate(got_all):
        want = ds[i]
        assert set(got) == set(want) and got["scene"] == want["scene"]
        for k in ("imgs", "intrinsics", "extrinsics"):
            np.testing.assert_array_equal(np.stack(got[k]), np.stack(want[k]), k)
        for k in ("proj_matrices", "world_to_aligned_camera", "vol_origin",
                  "vol_origin_partial"):
            np.testing.assert_array_equal(got[k], want[k], k)
        go, wo = got["occ_list"][0], want["occ_list"][0]
        assert (go & wo).sum() / max((go | wo).sum(), 1) > 0.8


def test_write_scene_matches_jax(tmp_path):
    """write_scene, port (native writers) and JAX (cv2), 5 frames of one
    textured scene, depth 120x160 and color 240x320: poses, intrinsics and
    label exports exact; depth exact after decoding; color decoded within
    a mean of 2 grey levels."""
    kw = dict(seed=3, n_frames=5, image_hw=(120, 160), color_hw=(240, 320))
    for side, write in (("port", tmake.write_scene), ("jax", jmake.write_scene)):
        write(str(tmp_path / side / "scans"), str(tmp_path / side / "labels"),
              "scene0003_00", **kw)
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 3 + 2 + 3 * 5
    for f in files:
        a, b = str(tmp_path / "port" / f), str(tmp_path / "jax" / f)
        if f.endswith(".txt"):
            np.testing.assert_array_equal(np.loadtxt(a), np.loadtxt(b), f)
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), f)
        elif f.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(b, cv2.IMREAD_UNCHANGED), f)
        else:
            ca, cb = cv2.imread(a).astype(np.float32), cv2.imread(b).astype(np.float32)
            assert ca.shape == cb.shape == (240, 320, 3)
            assert np.abs(ca - cb).mean() < 2.0, f


def test_generate_all_matches_jax(root, tmp_path):
    """generate_all on the JAX-written fixture, port (fusion on the CPU)
    against the JAX tool's tree: fragment pkls equal, tsdf_info and label
    volumes equal, each TSDF level within 1e-5 except voxels within 1e-4 px
    of a pixel-rounding boundary in some view, under
    torch_parity.assert_exemption_caps."""
    scans = tmp_path / "scans"
    os.symlink(root / "scans", scans)
    out = Path(tgt.generate_all(str(scans), "all_tsdf_9", voxel_size=0.24,
                                n_views=9, label_path=str(root / "labels"),
                                device="cpu"))
    ref = root / "all_tsdf_9"
    for split in ("train", "val", "test"):
        with open(out / f"fragments_{split}.pkl", "rb") as f:
            got = pickle.load(f)
        with open(ref / f"fragments_{split}.pkl", "rb") as f:
            want = pickle.load(f)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["scene"] == w["scene"]
            assert g["fragment_id"] == w["fragment_id"] and g["image_ids"] == w["image_ids"]
            np.testing.assert_array_equal(g["vol_origin"], w["vol_origin"])
    for scene in SCENES:
        assert sorted(os.listdir(out / scene)) == sorted(os.listdir(ref / scene))
        info = np.load(ref / scene / "tsdf_info.npz")
        with np.load(out / scene / "tsdf_info.npz") as z:
            for k in info.files:
                np.testing.assert_array_equal(z[k], info[k])
        for f in sorted(os.listdir(ref / scene)):
            if "semantic" in f or "instance" in f:
                np.testing.assert_array_equal(np.load(out / scene / f)["arr_0"],
                                              np.load(ref / scene / f)["arr_0"], f)
        frames = JaxSceneLoader(str(root / "scans"), scene).load_all()
        want = [np.load(ref / scene / f"full_tsdf_layer{l}.npz")["arr_0"] for l in range(3)]
        got = [np.load(out / scene / f"full_tsdf_layer{l}.npz")["arr_0"] for l in range(3)]
        near = rounding_boundary_levels(info["vol_origin"], np.stack(frames["poses"]),
                                        np.stack(frames["intrinsics"]),
                                        [w.shape for w in want], 0.24)
        differs = []
        for lvl, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            differs.append(np.abs(g - w) > TSDF_TOL)
            assert not (differs[-1] & ~near[lvl]).any(), (scene, lvl)
        assert_exemption_caps([d & n for d, n in zip(differs, near)])


def test_render_tsdf_depth_matches_jax(root):
    """render_tsdf_depth against JAX's at 60x80 on a fixture GT volume from
    two of its cameras: within 1e-4 m, and the rays that hit agree."""
    gt = root / "all_tsdf_9" / "scene0001_00"
    tsdf = np.load(gt / "full_tsdf_layer0.npz")["arr_0"]
    origin = np.load(gt / "tsdf_info.npz")["vol_origin"]
    frames = teval.load_test_frames(str(root), "scene0001_00", 6)
    for i in (0, 3):
        k = frames["intrinsics"][i].copy()
        k[:2] *= 0.5  # 120x160 -> 60x80
        p = frames["poses"][i]
        got = teval.render_tsdf_depth(torch.from_numpy(tsdf), origin, 0.24, k, p,
                                      hw=(60, 80)).numpy()
        want = np.asarray(jeval.render_tsdf_depth(
            jnp.asarray(tsdf), jnp.asarray(origin), 0.24, jnp.asarray(k),
            jnp.asarray(p), hw=(60, 80)))
        assert got.shape == want.shape == (60, 80)
        np.testing.assert_array_equal(got > 0, want > 0)
        assert (got > 0).mean() > 0.3
        np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_TOL)


def _pred_scene(root, scene, path):
    """A saved scene as run_test writes it: the GT TSDF with noise, one
    voxel off the GT origin."""
    gt = root / "all_tsdf_9" / scene
    tsdf = np.load(gt / "full_tsdf_layer0.npz")["arr_0"]
    origin = np.load(gt / "tsdf_info.npz")["vol_origin"]
    rng = np.random.default_rng(0)
    noisy = np.clip(tsdf + 0.1 * rng.standard_normal(tsdf.shape), -1, 1)
    np.savez(path, tsdf=noisy.astype(np.float32),
             origin=(origin + np.float32(0.24)).astype(np.float32),
             voxel_size=np.float32(0.24))


def test_evaluate_scene_and_main_match_jax(root, tmp_path):
    """load_test_frames equals JAX's (cv2) frame for frame; evaluate_scene
    (render at 2 held-out frames, depth metrics, trimmed re-fusion, mesh
    metrics) within 1e-4 of JAX's; the evaluation CLI writes the same
    <scene>_metrics.json keys and values (1e-4) and the same means."""
    scene = "scene0000_00"
    frames = teval.load_test_frames(str(root), scene, 2)
    jframes = jeval.load_test_frames(str(root), scene, 2)
    assert frames.keys() == jframes.keys()
    for k in frames:
        assert len(frames[k]) == len(jframes[k]) == 2
        for a, b in zip(frames[k], jframes[k]):
            np.testing.assert_array_equal(a, b, k)
    results = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        _pred_scene(root, scene, d / f"{scene}.npz")
        (d / f"{scene}_metrics.json").write_text(json.dumps({"PQ": 0.5}))
    verts = teval.gt_scene_verts(str(root / "all_tsdf_9"), scene)
    got = teval.evaluate_scene(str(tmp_path / "port" / f"{scene}.npz"), verts,
                               frames, max_frames=2, device="cpu")
    want = jeval.evaluate_scene(str(tmp_path / "jax" / f"{scene}.npz"), verts,
                                jframes, max_frames=2)
    assert got.keys() == want.keys() and {"AbsRel", "RMSE", "fscore"} <= got.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_TOL, abs=METRIC_TOL), k
    argv = ["--data_path", str(root), "--max_frames", "2"]
    results["port"] = teval.main(["--result_dir", str(tmp_path / "port"), *argv,
                                  "--device", "cpu"])
    results["jax"] = jeval.main(["--result_dir", str(tmp_path / "jax"), *argv])
    assert results["port"].keys() == results["jax"].keys()
    for k, v in results["jax"].items():
        assert results["port"][k] == pytest.approx(v, rel=METRIC_TOL, abs=METRIC_TOL,
                                                   nan_ok=True), k
    ma = json.loads((tmp_path / "port" / f"{scene}_metrics.json").read_text())
    mb = json.loads((tmp_path / "jax" / f"{scene}_metrics.json").read_text())
    assert ma.keys() == mb.keys() and ma["PQ"] == 0.5
    for k in mb:
        assert ma[k] == pytest.approx(mb[k], rel=METRIC_TOL, abs=METRIC_TOL), k


def test_data_prep_without_cv2_or_pil(root, tmp_path):
    """With cv2 and PIL made unimportable: dataset[0] and the prefetcher's
    first sample (equal images), generate_all on the fixture's scans
    (on the CPU) and load_test_frames run on the port's own decoders."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import os, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from eprecon_tpu_torch import main as tmain\n"
        "from eprecon_tpu_torch.config import load_config\n"
        "from eprecon_tpu_torch.data.prefetch import FragmentPrefetcher\n"
        "from eprecon_tpu_torch.tools import evaluation, generate_gt\n"
        "root, out = sys.argv[1], sys.argv[2]\n"
        "cfg = load_config(None, [('model.n_vox', (16, 16, 16)), "
        "('model.voxel_size', 0.24), ('train.path', root)])\n"
        "ds = tmain.build_dataset(cfg, 'train', device='cpu')\n"
        "a = ds[0]\n"
        "pf = FragmentPrefetcher(ds, n_threads=2)\n"
        "b = next(pf.iterate([0]))\n"
        "pf.close()\n"
        "assert np.array_equal(np.stack(a['imgs']), np.stack(b['imgs']))\n"
        "os.symlink(os.path.join(root, 'scans'), os.path.join(out, 'scans'))\n"
        "gt = generate_gt.generate_all(os.path.join(out, 'scans'), voxel_size=0.24, "
        "device='cpu')\n"
        "fr = evaluation.load_test_frames(root, 'scene0000_00', 3)\n"
        "bad = [m for m in ('cv2', 'PIL') if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
        "print(len(a['imgs']), len(os.listdir(gt)), len(fr['depths']))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(root), str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].split() == ["9", "5", "3"]
