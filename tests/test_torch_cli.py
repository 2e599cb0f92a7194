"""The port's CLI (`python -m eprecon_tpu_torch.main`) and what it reads
and writes, against the JAX package: the YAML configs and overrides, the
evaluation loop's output files and loss means, the scene scores against
the GT volumes; then the CLI itself on the CPU, train then test, on the
JAX tools' on-disk ScanNet-layout tree (`torch_parity.write_scannet_fixture`).
"""
import ast
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import one_torch_thread, write_scannet_fixture

from eprecon_tpu.config import load_config as jax_load_config
from eprecon_tpu.config import parse_cli_overrides as jax_parse
from eprecon_tpu.inference.pipeline import SceneResult
from eprecon_tpu.tools import evaluation as jeval
from eprecon_tpu.train import loop as jloop
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch import main as tmain
from eprecon_tpu_torch.tools import evaluation as teval
from eprecon_tpu_torch.train import loop as tloop

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ["config/train.yaml", "config/test.yaml"]
OVERRIDES = ["model.voxel_size", "0.08", "model.n_vox", "[48, 48, 32]",
             "train.lr_epochs", "'3,5:10'", "model.panoptic.num_queries", "16",
             "train.random_rotation_3d", "False", "test.eval_depth_frames", "2",
             "model.remat_mode", "none", "summary_freq", "1", "loadckpt", "x/y"]
METRIC_TOL = 1e-6   # scene scores: the same numpy/scipy code on both sides


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_scannet_fixture(tmp_path_factory.mktemp("synthscan"))


def _fields_equal(port, jax_cfg, path=""):
    """Every field the port's config has equals the JAX config's."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(got):
            _fields_equal(got, want, f"{path}{f.name}.")
        else:
            assert got == want and type(got) is type(want), (path + f.name, got, want)


@pytest.mark.parametrize("cfg_file", CONFIGS)
def test_config_matches_jax(cfg_file):
    """load_config of each YAML file, with and without CLI overrides (a
    JAX-only knob among them, accepted and ignored); the YAML subset parser
    equals yaml.safe_load; unknown keys raise KeyError."""
    path = REPO / cfg_file
    assert tconfig.parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())
    for opts in ([], OVERRIDES):
        assert tconfig.parse_cli_overrides(opts) == jax_parse(opts)
        port = tconfig.load_config(str(path), tconfig.parse_cli_overrides(opts))
        _fields_equal(port, jax_load_config(str(path), jax_parse(opts)))
    assert port.model.n_vox == (48, 48, 32) and port.test.eval_depth_frames == 2
    with pytest.raises(KeyError):
        tconfig.load_config(str(path), [("model.no_such_key", 1)])
    with pytest.raises(ValueError):
        tconfig.parse_yaml("a:\n  - 1\n")


class StubReconstructor:
    """Stands in for StreamingReconstructor: returns fixed scenes at each
    scene change and at flush, fixed loss scalars per fragment (made by
    `scalar`), and records what it was given."""

    def __init__(self, scenes, scalar, device=None):
        self.scenes, self.scalar, self.device = scenes, scalar, device
        self.current, self.last_losses, self.calls = None, {}, []

    def process_fragment(self, scene, imgs, proj_matrices, vol_origin,
                         vol_origin_partial, world_to_aligned_camera,
                         targets=None, anchor=None):
        n = len(self.calls)
        self.calls.append(dict(
            scene=scene, imgs=np.asarray(imgs), anchor=anchor,
            targets=[np.asarray(x) for x in
                     (*targets.tsdf, *targets.occ, targets.semantic,
                      targets.instance)]))
        finished = (self.scenes[self.current]
                    if self.current not in (None, scene) else None)
        self.current = scene
        self.last_losses = {"tsdf_occ_loss_0": self.scalar(0.25 + 0.125 * n),
                            "total_loss": self.scalar(1.0 / (n + 3))}
        return finished

    def snapshot(self):
        return self.scenes[self.current]

    def flush(self):
        return self.scenes[self.current]


def _gt_scene(root, name, seed, shift=(1, 0, 0)):
    """A finished scene made from the tree's GT: the GT TSDF with noise,
    shifted by `shift` voxels, and its labels."""
    gt = Path(root) / "all_tsdf_9" / name
    tsdf = np.load(gt / "full_tsdf_layer0.npz")["arr_0"]
    sem = np.load(gt / "full_semantic_layer_interpolate0.npz")["arr_0"]
    ins = np.load(gt / "full_instance_layer_interpolate0.npz")["arr_0"]
    origin = np.load(gt / "tsdf_info.npz")["vol_origin"].astype(np.float32)
    rng = np.random.default_rng(seed)
    noisy = np.clip(tsdf + 0.1 * rng.standard_normal(tsdf.shape), -1, 1)
    return SceneResult(name, origin + 0.24 * np.asarray(shift, np.float32), 0.24,
                       noisy.astype(np.float32), ins.astype(np.int32),
                       sem.astype(np.int32))


def _samples(rng):
    """Fragments of the two fixture scenes as the data pipeline yields
    them (small arrays: the stub runs no model)."""
    out = []
    for name in ["scene0000_00"] * 2 + ["scene0001_00"] * 2:
        out.append(dict(
            scene=name, imgs=list(rng.uniform(0, 255, (3, 4, 6, 3)).astype(np.float32)),
            proj_matrices=rng.standard_normal((3, 3, 4, 4)).astype(np.float32),
            vol_origin=rng.standard_normal(3).astype(np.float32),
            vol_origin_partial=rng.standard_normal(3).astype(np.float32),
            world_to_aligned_camera=np.eye(4, dtype=np.float32),
            global_anchor=rng.standard_normal(3).astype(np.float32),
            tsdf_list=[rng.uniform(-1, 1, (4 // 2 ** l,) * 3).astype(np.float32)
                       for l in range(3)],
            occ_list=[rng.uniform(size=(4 // 2 ** l,) * 3) < 0.5 for l in range(3)],
            semantic=rng.integers(0, 20, (4, 4, 4)).astype(np.int32),
            instance=rng.integers(0, 9, (4, 4, 4)).astype(np.int32)))
    return out


def test_evaluate_matches_jax(root, tmp_path):
    """evaluate, port and JAX, over the same fragments with one stub
    reconstructor each: the same arguments reach it; the saved .npz arrays
    are equal, the .ply files byte for byte, the <scene>_metrics.json
    files within 1e-6, and the eval-loss means are equal."""
    scenes = {n: _gt_scene(root, n, s) for s, n in
              enumerate(["scene0000_00", "scene0001_00"])}
    gt_dir = str(Path(root) / "all_tsdf_9")
    jcfg = jax_load_config(None, [("save_incremental", True)])
    tcfg = tconfig.load_config(None, [("save_incremental", True)])
    logs, stubs = {}, {}
    for side, cfg, evaluate, scalar in (
            ("jax", jcfg, jloop.evaluate, lambda x: jnp.asarray(x, jnp.float32)),
            ("port", tcfg, tloop.evaluate,
             lambda x: torch.tensor(x, dtype=torch.float32))):
        stubs[side] = StubReconstructor(scenes, scalar, torch.device("cpu"))
        logs[side] = []
        samples = _samples(np.random.default_rng(0))
        evaluate(cfg, stubs[side], iter(samples), out_dir=str(tmp_path / side),
                 log_fn=logs[side].append, gt_dir=gt_dir)
    for a, b in zip(stubs["port"].calls, stubs["jax"].calls):
        assert a["scene"] == b["scene"]
        np.testing.assert_array_equal(a["imgs"], b["imgs"])
        np.testing.assert_array_equal(a["anchor"], b["anchor"])
        for x, y in zip(a["targets"], b["targets"]):
            np.testing.assert_array_equal(x, y)
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert sum(f.endswith("_metrics.json") for f in files) == 2
    assert sum(f.startswith("incremental") for f in files) == 12
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".ply"):
            assert a.read_bytes() == b.read_bytes(), f
        elif f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], f"{f}:{k}")
        else:
            ma, mb = json.loads(a.read_text()), json.loads(b.read_text())
            assert ma.keys() == mb.keys() and "fscore" in ma and "PQ" in ma
            for k in ma:
                assert ma[k] == pytest.approx(mb[k], rel=METRIC_TOL,
                                              abs=METRIC_TOL), (f, k)
    means = {}
    for side, lines in logs.items():
        (line,) = [x for x in lines if x.startswith("eval losses over 4 ")]
        means[side] = ast.literal_eval(line.split(": ", 1)[1])
    assert means["port"] == means["jax"]


def test_evaluate_scene_vs_gt_matches_jax(root):
    """The closed-loop scene score (mesh F-score, label transfer and PQ)
    and the GT vertices on the tree's GT: within 1e-6."""
    for seed, shift in ((0, (0, 0, 0)), (1, (1, -1, 0))):
        res = _gt_scene(root, "scene0001_00", seed, shift)
        gt_dir = str(Path(root) / "all_tsdf_9")
        got, want = teval.evaluate_scene_vs_gt(res, gt_dir), \
            jeval.evaluate_scene_vs_gt(res, gt_dir)
        assert got.keys() == want.keys() and {"fscore", "PQ"} <= got.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_TOL,
                                           abs=METRIC_TOL), k
        assert 0 < got["fscore"] <= 1
    np.testing.assert_allclose(teval.gt_scene_verts(gt_dir, "scene0001_00"),
                               jeval.gt_scene_verts(gt_dir, "scene0001_00"),
                               rtol=0, atol=METRIC_TOL)


def micro_overrides(root, logdir):
    """KEY VALUE overrides of config/{train,test}.yaml for the micro config
    (__graft_entry__._micro_cfg widths) on the tree at `root`."""
    return ["train.path", str(root), "test.path", str(root), "logdir", str(logdir),
            "model.n_vox", "[16,16,16]", "model.voxel_size", "0.24",
            "model.voxel_capacity", "[128,512,2048]",
            "model.global_extent", "[32,32,16]", "model.min_init_voxels", "10",
            "model.min_stage_voxels", "5", "model.panoptic.num_queries", "16",
            "model.panoptic.dec_layers", "1", "model.panoptic.max_instances", "8",
            "model.panoptic.hidden_dim", "16", "model.panoptic.nheads", "4"]


CLI_VIEWS = 3


def _one_fragment_tree(root, dest):
    """The fixture with each split cut to its first fragment, of which
    CLI_VIEWS keyframes spread over its 9 (links to the same scans and GT
    volumes): the CLI run on the CPU then takes one training step and one
    test fragment of 3 views at 640x480."""
    os.makedirs(dest / "all_tsdf_9")
    for name in ("scans", "scans_test"):
        os.symlink(Path(root) / name, dest / name)
    for scene in ("scene0000_00", "scene0001_00"):
        os.symlink(Path(root) / "all_tsdf_9" / scene, dest / "all_tsdf_9" / scene)
    for split in ("train", "test"):
        pkl = Path(root) / "all_tsdf_9" / f"fragments_{split}.pkl"
        with open(pkl, "rb") as f:
            frags = pickle.load(f)
        first = dict(frags[0], image_ids=frags[0]["image_ids"][::4][:CLI_VIEWS])
        with open(dest / "all_tsdf_9" / f"fragments_{split}.pkl", "wb") as f:
            pickle.dump([first], f)
    return dest


def test_cli_train_then_test_on_cpu(root, tmp_path):
    """python -m eprecon_tpu_torch.main --cfg config/train.yaml --device cpu,
    then --cfg config/test.yaml with the checkpoint: the checkpoint,
    metrics.jsonl, the scene's volumes, meshes and scores are written."""
    tree = _one_fragment_tree(root, tmp_path / "tree")
    logdir = tmp_path / "run"
    # one torch thread: see torch_parity.one_torch_thread
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "eprecon_tpu_torch.main", "--device", "cpu"]
    views = ["train.n_views", str(CLI_VIEWS), "test.n_views", str(CLI_VIEWS)]
    train = subprocess.run(
        base + ["--cfg", "config/train.yaml", *micro_overrides(tree, logdir),
                *views, "train.epochs", "1", "summary_freq", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    assert (logdir / "model_000000").is_file()
    (record,) = [json.loads(x) for x in (logdir / "metrics.jsonl").open()]
    assert record["step"] == 1 and np.isfinite(record["total_loss"])
    assert re.search(r"^epoch 0: ", train.stdout, re.M), train.stdout
    test = subprocess.run(
        base + ["--cfg", "config/test.yaml", *micro_overrides(tree, logdir),
                *views, "loadckpt", str(logdir / "model_000000")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert test.returncode == 0, test.stderr[-3000:]
    scenes = logdir / "scenes"
    for suffix in (".npz", ".ply", "_metrics.json"):
        assert (scenes / f"scene0000_00{suffix}").is_file(), sorted(os.listdir(scenes))
    with np.load(scenes / "scene0000_00.npz") as z:
        assert np.isfinite(z["tsdf"]).all()
    assert "eval losses over 1 fragments" in test.stdout, test.stdout


def test_main_refuses_without_cuda(monkeypatch):
    """Without --device the CLI asks for CUDA and raises where it is
    absent; the depth protocol raises, naming its ROADMAP item."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--cfg", str(REPO / "config/test.yaml")])
    cfg = tconfig.load_config(str(REPO / "config/test.yaml"),
                              [("test.eval_depth_frames", 3)])
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        tmain.run_test(cfg, "cpu")
