"""Raw ScanNet and ARKit data into the port, held against the JAX package on
the CPU: PLY reading (exact), .sens parsing and extraction on a 4-frame
scan packed from the port's synthetic tree (poses and intrinsics exact,
color bytes equal, depth equal decoded; JAX's side writes depth with cv2),
the label export and the benchmark label transfer (exact), ARKit poses,
sync and fragments (exact), the downloader's URLs and files (no socket
opens), and the ingestion path with jax, cv2 and PIL unimportable."""
import os
import pickle
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import cv2
import numpy as np
import pytest

from eprecon_tpu.tools import download_scannet as jdl
from eprecon_tpu.tools import generate_semantic_instance as jgsi
from eprecon_tpu.tools import load_scannet_labels as jlabels
from eprecon_tpu.tools import ply_io as jply
from eprecon_tpu.tools import process_arkit_data as jarkit
from eprecon_tpu.tools import sens_reader as jsens
from eprecon_tpu_torch.data import native_loader as nl
from eprecon_tpu_torch.inference.mesh_export import write_ply
from eprecon_tpu_torch.tools import download_scannet as dl
from eprecon_tpu_torch.tools import generate_semantic_instance as gsi
from eprecon_tpu_torch.tools import import_reference_weights as irw
from eprecon_tpu_torch.tools import load_scannet_labels as labels_mod
from eprecon_tpu_torch.tools import ply_io
from eprecon_tpu_torch.tools import process_arkit_data as arkit
from eprecon_tpu_torch.tools import sens_reader
from eprecon_tpu_torch.tools.make_synthetic_scannet import write_scene
from torch_parity import (one_torch_thread, pack_scene_sens, scannet_renumbered,
                          write_label_tsv, write_ply_binary,
                          write_reference_checkpoint, write_scannet_annotations)

REPO = Path(__file__).resolve().parents[1]
SCENE = "scene0000_00"
FRAMES = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def raw_scan(tmp_path_factory):
    """A 4-frame scene written by the port (depth 60x80, color 96x128),
    packed as a raw ScanNet scan: <raw>/<scene>/<scene>.sens, the mesh,
    segs and aggregation files, and the label tsv beside the scans."""
    root = tmp_path_factory.mktemp("ingest")
    write_scene(str(root / "scans"), str(root / "labels"), SCENE, seed=0,
                n_frames=FRAMES, image_hw=(60, 80), color_hw=(96, 128))
    raw = root / "raw"
    scan = raw / SCENE
    scan.mkdir(parents=True)
    assert pack_scene_sens(root / "scans" / SCENE, scan / f"{SCENE}.sens") == FRAMES
    lab = {k: np.load(root / "labels" / f"{SCENE}_{k}.npy")
           for k in ("vert", "sem_label", "ins_label")}
    write_scannet_annotations(scan, SCENE, lab["vert"][:, :3], lab["sem_label"],
                              lab["ins_label"])
    write_label_tsv(raw / "scannetv2-labels.combined.tsv")
    return root, lab


def test_ply_ascii_matches_jax(tmp_path):
    """A mesh written by the port's write_ply (ascii), with and without
    colours: vertices and whole meshes equal JAX's reading, exactly."""
    rng = np.random.default_rng(0)
    verts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (30, 3))
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    for name, c in (("plain.ply", None), ("color.ply", colors)):
        path = str(tmp_path / name)
        write_ply(path, verts, faces, c)
        got, want = ply_io.read_ply_vertices(path), jply.read_ply_vertices(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.abs(got - verts).max() <= 5e-5   # 4 decimals
        for g, w in zip(ply_io.read_ply_mesh(path), jply.read_ply_mesh(path)):
            assert (g is None and w is None) or np.array_equal(g, w)


def test_ply_binary_matches_jax(tmp_path):
    """A binary little-endian PLY with ScanNet's vertex properties: the
    port reads JAX's vertices, equal to the written f32 values."""
    verts = np.random.default_rng(1).normal(0, 3, (64, 3)).astype(np.float32)
    path = str(tmp_path / "scan_vh_clean_2.ply")
    write_ply_binary(path, verts)
    got = ply_io.read_ply_vertices(path)
    assert np.array_equal(got, jply.read_ply_vertices(path))
    assert np.array_equal(got, verts)


def test_sens_reader_matches_jax(raw_scan):
    root, _ = raw_scan
    path = str(root / "raw" / SCENE / f"{SCENE}.sens")
    got, want = sens_reader.SensReader(path), jsens.SensReader(path)
    try:
        for attr in ("version", "sensor_name", "color_compression",
                     "depth_compression", "color_width", "color_height",
                     "depth_width", "depth_height", "depth_shift",
                     "num_frames"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert (got.version, got.num_frames) == (4, FRAMES)
        for attr in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
                     "extrinsic_depth"):
            assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
        n = 0
        for (gp, gc, gd), (wp, wc, wd) in zip(got.frames(), want.frames()):
            assert np.array_equal(gp, wp) and gp.dtype == np.float32
            assert gc == wc and gc[:2] == b"\xff\xd8"
            assert np.array_equal(gd, wd) and gd.dtype == wd.dtype
            n += 1
        assert n == FRAMES
    finally:
        got.close()
        want.close()


def test_extract_matches_jax(raw_scan, tmp_path):
    """The port's extract against JAX's (cv2's PNG writer): intrinsics and
    poses exactly, color bytes equal, depth equal decoded; and the tree's
    source frames come back (poses at the .sens format's f32)."""
    root, _ = raw_scan
    path = str(root / "raw" / SCENE / f"{SCENE}.sens")
    port, jax_out, src = tmp_path / "port", tmp_path / "jax", root / "scans" / SCENE
    assert sens_reader.extract(path, str(port)) == FRAMES
    jsens.extract(path, str(jax_out))
    for name in ("intrinsic_color.txt", "intrinsic_depth.txt"):
        a = (port / "intrinsic" / name).read_text()
        assert a == (jax_out / "intrinsic" / name).read_text()
        assert np.array_equal(np.loadtxt(port / "intrinsic" / name),
                              np.loadtxt(src / "intrinsic" / name))
    for i in range(FRAMES):
        assert ((port / "pose" / f"{i}.txt").read_text()
                == (jax_out / "pose" / f"{i}.txt").read_text())
        assert np.array_equal(np.loadtxt(port / "pose" / f"{i}.txt"),
                              np.loadtxt(src / "pose" / f"{i}.txt").astype(np.float32))
        color = (port / "color" / f"{i}.jpg").read_bytes()
        assert color == (jax_out / "color" / f"{i}.jpg").read_bytes()
        assert color == (src / "color" / f"{i}.jpg").read_bytes()
        got = cv2.imread(str(port / "depth" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(jax_out / "depth" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16 and np.array_equal(got, want)
        assert np.array_equal(nl.decode_png_depth(str(port / "depth" / f"{i}.png")),
                              nl.decode_png_depth(str(src / "depth" / f"{i}.png")))


def test_label_export_matches_jax(raw_scan, tmp_path):
    """export and main against JAX's, exactly; the labels are the tree's,
    the instances renumbered wall 1, floor 2, things from 3."""
    root, lab = raw_scan
    raw = root / "raw"
    label_map = labels_mod.read_label_mapping(str(raw / "scannetv2-labels.combined.tsv"))
    assert label_map == jlabels.read_label_mapping(
        str(raw / "scannetv2-labels.combined.tsv"))
    got = labels_mod.export(str(raw / SCENE), SCENE, label_map)
    want = jlabels.export(str(raw / SCENE), SCENE, label_map)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    verts, sem, ins = got
    assert np.array_equal(verts, lab["vert"])
    assert np.array_equal(sem, lab["sem_label"])
    assert np.array_equal(ins, scannet_renumbered(lab["sem_label"], lab["ins_label"]))
    assert set(np.unique(ins)) >= {2, 3}
    args = ["--scannet_path", str(raw), "--label_map_file",
            str(raw / "scannetv2-labels.combined.tsv"), "--output_folder"]
    labels_mod.main(args + [str(tmp_path / "port")])
    sys_argv = sys.argv
    try:
        sys.argv = ["load_scannet_labels"] + args + [str(tmp_path / "jax")]
        jlabels.main()
    finally:
        sys.argv = sys_argv
    for k in ("vert", "sem_label", "ins_label"):
        name = f"{SCENE}_{k}.npy"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_benchmark_export_matches_jax(tmp_path):
    """transfer_labels_to_vertices (nearest voxel, then nearest labeled
    vertex through cKDTree) and export_scene's files against JAX's."""
    rng = np.random.default_rng(3)
    dim = (12, 10, 8)
    sem = rng.integers(0, 21, dim).astype(np.int32)
    sem[rng.random(dim) < 0.5] = 0
    ins = np.where(sem > 0, rng.integers(1, 6, dim), 0).astype(np.int32)
    origin, vsz = np.array([0.5, -1.0, 0.2], np.float32), 0.08
    verts = (origin + rng.uniform(-0.1, 1.0, (300, 3)) * np.array(dim) * vsz
             ).astype(np.float32)
    got = gsi.transfer_labels_to_vertices(verts, origin, vsz, sem, ins)
    want = jgsi.transfer_labels_to_vertices(verts, origin, vsz, sem, ins)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert (got[0] > 0).all()
    npz = tmp_path / "scene0001_00.npz"
    np.savez(npz, origin=origin, voxel_size=vsz, semantic=sem, instance=ins,
             tsdf=np.zeros(dim, np.float32))
    gsi.export_scene(str(npz), verts, str(tmp_path / "port"))
    jgsi.export_scene(str(npz), verts, str(tmp_path / "jax"))
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) > 2
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _arkit_capture(path: Path, n: int = 30):
    """An ARKit capture without video: images/N.jpg, Frames.txt (camera at
    30 Hz) and ARposes.txt (60 Hz, walking 5 cm per frame and turning)."""
    rng = np.random.default_rng(4)
    (path / "images").mkdir(parents=True)
    for i in range(n):
        (path / "images" / f"{i}.jpg").write_bytes(b"\xff\xd8")
    with open(path / "Frames.txt", "w") as f:
        for i in range(n + 3):
            f.write(f"{i / 30 + 1e-3 * rng.random():.6f}, {i}, 500.0, 501.0, "
                    f"320.5, 240.5\n")
    with open(path / "ARposes.txt", "w") as f:
        for j in range(2 * n + 6):
            a = 0.01 * j
            q = np.array([np.cos(a), 0.0, np.sin(a), 0.1])
            q /= np.linalg.norm(q)
            f.write(f"{j / 60:.6f}, {0.025 * j:.4f}, 0.1, {0.01 * j:.4f}, "
                    + ", ".join(f"{v:.6f}" for v in q) + "\n")
        f.write("0.5, 1.0\n")   # short: skipped


def test_arkit_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        assert np.array_equal(arkit.quat_to_mat(q), jarkit.quat_to_mat(q))
        assert np.array_equal(arkit.arkit_pose_to_scannet(t, q),
                              jarkit.arkit_pose_to_scannet(t, q))
    pose_ts, frame_ts = np.sort(rng.uniform(0, 10, 200)), rng.uniform(-1, 11, 50)
    assert np.array_equal(arkit.sync_by_timestamp(frame_ts, pose_ts),
                          jarkit.sync_by_timestamp(frame_ts, pose_ts))
    for name in ("port", "jax"):
        _arkit_capture(tmp_path / name)
    for loader in ("load_arkit_poses", "load_intrinsics"):
        fname = "ARposes.txt" if loader == "load_arkit_poses" else "Frames.txt"
        got = getattr(arkit, loader)(str(tmp_path / "port" / fname))
        want = getattr(jarkit, loader)(str(tmp_path / "jax" / fname))
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = arkit.process_data(str(tmp_path / "port"), n_views=3)
    want = jarkit.process_data(str(tmp_path / "jax"), n_views=3)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k
    with open(tmp_path / "port" / "fragments.pkl", "rb") as f:
        saved = pickle.load(f)
    assert all(np.array_equal(s["poses"], g["poses"]) for s, g in zip(saved, got))


def test_extract_frames_needs_cv2(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="needs OpenCV"):
        arkit.extract_frames(str(tmp_path / "Frames.m4v"), str(tmp_path / "out"))


def test_download_matches_jax_without_network(monkeypatch, tmp_path):
    """The same URLs, files and order as JAX's downloader, with sockets
    made to raise and urlretrieve recording its calls."""
    def no_socket(*a, **kw):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setattr(socket, "create_connection", no_socket)
    calls = []

    def fake_retrieve(url, filename):
        calls.append((url, os.path.relpath(filename, tmp_path)))
        Path(filename).write_text(url)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    monkeypatch.setattr("builtins.input", lambda prompt="": "")
    for attr in ("BASE_URL", "TOS_URL", "RELEASE", "RELEASE_TASKS", "FILE_TYPES"):
        assert getattr(dl, attr) == getattr(jdl, attr), attr
    runs = {}
    for name, mod in (("port", dl), ("jax", jdl)):
        calls.clear()
        out = tmp_path / name
        ids = out / "ids.txt"
        out.mkdir()
        ids.write_text("scene0000_00\nscene0001_01\n")
        argv = ["-o", str(out), "--scans_file", str(ids), "--label_map"]
        if mod is dl:
            mod.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["download_scannet"] + argv)
            mod.main()
        mod.download_scan("scene0002_00", str(out / "one"))
        mod.download_scan("scene0002_00", str(out / "one"))   # present: skipped
        runs[name] = [(u, os.path.relpath(p, name)) for u, p in calls]
    assert runs["port"] == runs["jax"]
    assert len(runs["port"]) == 1 + 3 * len(dl.FILE_TYPES)
    assert runs["port"][1] == (
        f"{dl.BASE_URL}v2/scans/scene0000_00/scene0000_00.sens",
        "scans/scene0000_00/scene0000_00.sens.tmp")


def test_ingest_without_jax_or_image_libraries(raw_scan, tmp_path):
    """extract, the label export, the GT generator on the ingested tree and
    the reference importer, in a process where jax, flax, eprecon_tpu, cv2
    and PIL cannot be imported."""
    root, lab = raw_scan
    ckpt = tmp_path / "ref.ckpt"
    write_reference_checkpoint(ckpt, irw.random_state_dict(irw.all_entries()[0], 0))
    tree = tmp_path / "tree"
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "eprecon_tpu", "cv2", "PIL"):
    sys.modules[name] = None
from eprecon_tpu_torch.tools import (generate_gt, import_reference_weights,
                                     load_scannet_labels, sens_reader)
raw, tree = {str(root / 'raw')!r}, {str(tree)!r}
n = sens_reader.extract(raw + "/{SCENE}/{SCENE}.sens", tree + "/scans/{SCENE}")
load_scannet_labels.main(["--scannet_path", raw, "--label_map_file",
                          raw + "/scannetv2-labels.combined.tsv",
                          "--output_folder", tree + "/labels"])
generate_gt.generate_all(tree + "/scans", "all_tsdf_9", 0.24, 2,
                         label_path=tree + "/labels", device="cpu")
out = import_reference_weights.main(["--torch_ckpt", {str(ckpt)!r},
                                     "--out", tree + "/imported.pt"])
print("ok", n, len(out))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-3:-1] == ["ok", str(FRAMES)]
    assert int(proc.stdout.split()[-1]) > 900
    gt = tree / "all_tsdf_9" / SCENE
    assert (gt / "full_tsdf_layer0.npz").is_file()
    assert (gt / "full_semantic_layer0.npz").is_file()
    assert np.array_equal(np.load(tree / "labels" / f"{SCENE}_sem_label.npy"),
                          lab["sem_label"])
