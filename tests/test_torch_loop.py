"""The port's training loop on the CPU at the micro config
(__graft_entry__._micro_cfg widths, 3 views at 48x64), and its pieces
held against the JAX package's: the device arguments of a sample, the
scene origin, the mesh export.

Loop behaviour: two epochs straight equal one epoch, its checkpoint and a
resumed epoch bit for bit; the recurrent state resets exactly on a change
of (scene, epoch); the stop file checkpoints and returns; the RSS limit
exits 75; metrics.jsonl holds the means of the per-step metrics.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from torch_parity import one_torch_thread, port_model_config

from eprecon_tpu.inference import mesh_export as jmesh
from eprecon_tpu.inference.pipeline import SceneResult as JaxSceneResult
from eprecon_tpu.train import loop as jloop
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
from eprecon_tpu_torch.inference import mesh_export as tmesh
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.train import checkpoint as ckpt
from eprecon_tpu_torch.train import loop as tloop
from eprecon_tpu_torch.train.state import Trainer

SCENES = ("a", "a", "b")   # one epoch: two fragments of a, one of b


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(logdir, summary_freq=1):
    m = port_model_config(g._micro_cfg().model)
    cfg = tconfig.default_config()
    return dataclasses.replace(
        cfg, model=m, logdir=str(logdir), summary_freq=summary_freq,
        train=dataclasses.replace(cfg.train, epochs=2, accumulation_steps=2))


def _sample(d, scene, vol_origin):
    """A data-pipeline sample (the keys ScanNetDataset yields) from a
    synthetic fragment."""
    return dict(scene=scene, imgs=list(d["imgs"]), vol_origin=vol_origin,
                proj_matrices=d["proj_matrices"],
                vol_origin_partial=d["vol_origin_partial"],
                world_to_aligned_camera=d["world_to_aligned_camera"],
                tsdf_list=d["tsdf_levels"], occ_list=d["occ_levels"],
                semantic=d["semantic"], instance=d["instance"])


@pytest.fixture(scope="module")
def samples():
    m = _cfg("").model
    out = {}
    for epoch in range(2):
        for i, name in enumerate(SCENES):
            seed = {"a": 0, "b": 4}[name]
            d = make_fragment(n_views=3, image_hw=(48, 64), n_vox=m.n_vox,
                              voxel_size=m.voxel_size, scene=make_scene(seed),
                              start_angle=0.3 * i + 0.1 * epoch)
            out[epoch, i] = _sample(d, name, d["vol_origin_partial"] - 0.48)
    return out


class Recorder:
    """Wraps a Trainer's step and recurrent_state: records each step's
    metrics read one by one, and which steps started from a fresh state."""

    def __init__(self, trainer):
        self.metrics, self.fresh_at, self._fresh = [], [], set()
        step, fresh = trainer.step, trainer.recurrent_state

        def recurrent_state():
            rec = fresh()
            self._fresh.add(id(rec))
            return rec

        def recorded_step(imgs, frag, targets, rec):
            if id(rec) in self._fresh:
                self.fresh_at.append(trainer.step_count)
            out_rec, metrics = step(imgs, frag, targets, rec)
            self.metrics.append({k: float(v) for k, v in metrics.items()})
            return out_rec, metrics

        trainer.recurrent_state = recurrent_state
        trainer.step = recorded_step


def _run(cfg, samples, epochs=None, trainer=None, stop_after=None):
    trainer = trainer or Trainer(cfg, EPRecon(cfg.model, seed=1), "cpu",
                                 steps_per_epoch=len(SCENES))
    rec = Recorder(trainer)

    def iter_epoch(epoch):
        for i in range(len(SCENES)):
            if stop_after is not None and trainer.step_count == stop_after:
                open(os.environ["EPRECON_STOP_FILE"], "w").close()
            yield samples[epoch, i]

    tloop.train_epochs(cfg, trainer, iter_epoch, epochs=epochs,
                       log_fn=lambda _: None)
    return trainer, rec


@pytest.fixture(scope="module")
def runs(samples, tmp_path_factory):
    """Two epochs straight (summary every 2 steps); then, in another
    logdir, a trainer (other initial weights) resumed from the straight
    run's first checkpoint, written after epoch 0 as a one-epoch run
    writes it, trains the second epoch."""
    straight_dir = tmp_path_factory.mktemp("straight")
    straight, rec = _run(_cfg(straight_dir, summary_freq=2), samples)
    split_dir = tmp_path_factory.mktemp("split")
    cfg = _cfg(split_dir)
    resumed = Trainer(cfg, EPRecon(cfg.model, seed=7), "cpu",
                      steps_per_epoch=len(SCENES))
    ckpt.restore_checkpoint(str(straight_dir / "model_000000"), resumed)
    assert (resumed.epoch, resumed.step_count) == (1, len(SCENES))
    resumed, _ = _run(cfg, samples, trainer=resumed)
    return dict(straight=straight, straight_dir=straight_dir, rec=rec,
                resumed=resumed, split_dir=split_dir)


def test_resume_equals_straight_run(runs):
    """Bitwise equal parameters, buffers, optimizer state, step and epoch;
    the straight run wrote model_000000 and model_000001, the resumed one
    model_000001."""
    a, b = runs["straight"].state_dict(), runs["resumed"].state_dict()
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (6, 2)
    for name, x in a["model"].items():
        assert torch.equal(x, b["model"][name]), name
    for key in ("mu", "nu", "acc"):
        for name, x in a["optimizer"][key].items():
            assert torch.equal(x, b["optimizer"][key][name]), (key, name)
    for key in ("mini_step", "updates"):
        assert a["optimizer"][key] == b["optimizer"][key]
    assert a["optimizer"]["updates"] == 3
    for d, names in ((runs["straight_dir"], ["model_000000", "model_000001"]),
                     (runs["split_dir"], ["model_000001"])):
        assert sorted(f for f in os.listdir(d) if f.startswith("model_")) == names


def test_state_resets_on_scene_and_epoch_change(runs):
    """A fresh recurrent state at the first step of each (scene, epoch):
    steps 0 (a), 2 (b), 3 (a, epoch 1), 5 (b); fragments of one scene in
    one epoch thread the state."""
    assert runs["rec"].fresh_at == [0, 2, 3, 5]
    metrics = runs["rec"].metrics
    assert len(metrics) == 6
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert all(m["total_loss"] > 0 for m in metrics)


def test_metrics_jsonl_holds_window_means(runs):
    """Each record (every summary_freq = 2 steps) holds the means of the
    per-step metrics read one by one, with the loop's step timing."""
    with open(runs["straight_dir"] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    metrics = runs["rec"].metrics
    assert [r["step"] for r in records] == [2, 4, 6]
    for r, pair in zip(records, zip(metrics[::2], metrics[1::2])):
        assert r["mode"] == "train"
        for k in metrics[0]:
            want = (pair[0][k] + pair[1][k]) / 2
            assert r[k] == pytest.approx(want, rel=1e-12, abs=1e-12), k
        assert r["step_ms"] > 0 and 0 <= r["sample_ms"] <= r["step_ms"]


def test_stop_file_checkpoints_and_returns(samples, tmp_path, monkeypatch):
    monkeypatch.setenv("EPRECON_STOP_FILE", str(tmp_path / "STOP"))
    cfg = _cfg(tmp_path / "run")
    trainer, _ = _run(cfg, samples, stop_after=1)
    assert (trainer.step_count, trainer.epoch) == (1, 0)
    saved = torch.load(ckpt.latest_checkpoint(cfg.logdir), weights_only=True)
    assert (saved["step"], saved["epoch"]) == (1, 0)


def test_rss_limit_exits_75(samples, tmp_path, monkeypatch):
    monkeypatch.setenv("EPRECON_MAX_RSS_GB", "1e-6")
    cfg = _cfg(tmp_path / "run")
    with pytest.raises(SystemExit) as exc:
        _run(cfg, samples)
    assert exc.value.code == tloop.RSS_RESTART_EXIT_CODE == 75
    assert ckpt.latest_checkpoint(cfg.logdir) is not None


def test_device_args_and_scene_origin_match_jax(samples):
    """fragment_to_device_args and _scene_origin, both anchorings, with and
    without a window-union anchor: equal to the JAX package's."""
    jcfg = g._micro_cfg()
    tcfg = _cfg("")
    s = dict(samples[0, 1], global_anchor=np.array([-1.2, 0.48, -0.72],
                                                   np.float32))
    for anchor in ("window_union", "vol_origin"):
        jc = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, scene_anchor=anchor))
        tc = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, scene_anchor=anchor))
        for data in (s, samples[0, 1]):
            jo, to = jloop._scene_origin(jc, data), tloop._scene_origin(tc, data)
            np.testing.assert_array_equal(to, jo)
            jimgs, jfrag, jt = jloop.fragment_to_device_args(jc, data, jo)
            timgs, tfrag, tt = tloop.fragment_to_device_args(
                tc, data, to, torch.device("cpu"))
            np.testing.assert_array_equal(timgs.numpy(), np.asarray(jimgs))
            for a, b in zip(tfrag, jfrag):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(tt.tsdf + tt.occ + (tt.semantic, tt.instance),
                            jt.tsdf + jt.occ + (jt.semantic, jt.instance)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mesh_export_matches_jax(tmp_path):
    """surface_nets equal; save_scene writes the same files: PLY meshes
    (plain and label-coloured) byte for byte, npz volumes array for array
    (a zip member records its write time)."""
    rng = np.random.default_rng(3)
    xyz = np.stack(np.meshgrid(*[np.arange(n) for n in (14, 12, 10)],
                               indexing="ij"), -1)
    tsdf = np.clip((np.linalg.norm(xyz - [7, 6, 5], axis=-1) - 4) / 3, -1, 1)
    tsdf = (tsdf + 0.05 * rng.standard_normal(tsdf.shape)).astype(np.float32)
    for a, b in zip(tmesh.surface_nets(tsdf), jmesh.surface_nets(tsdf)):
        np.testing.assert_array_equal(a, b)
    labels = rng.integers(0, 21, tsdf.shape).astype(np.int32)
    res = JaxSceneResult("scene_x", np.array([0.5, -1.0, 0.25], np.float32),
                         0.04, tsdf, labels, labels % 7)
    tmesh.save_scene(res, str(tmp_path / "port"))
    jmesh.save_scene(res, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for n in names:
        a, b = tmp_path / "port" / n, tmp_path / "jax" / n
        if n.endswith(".ply"):
            assert a.read_bytes() == b.read_bytes(), n
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert za.files == zb.files
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], k)


def test_utils_timing_trace_and_logging(tmp_path):
    """utils/: time_fn and StepTimer time a CPU function; device_trace
    writes a Chrome trace that summarize_trace ranks (host operators where
    there is no card); host_memory_mb reads the resident set;
    setup_logger writes a log file; SummaryWriter appends JSONL records."""
    from eprecon_tpu_torch.utils import benchmark, logging as tlog, profiling

    x = torch.randn(64, 64)
    assert benchmark.time_fn(torch.mm, x, x, iters=3, warmup=1) > 0
    timer = profiling.StepTimer()
    assert timer.tick() >= 0 and timer.count == 1 and timer.mean >= 0
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.mm(x, x).sum()
    rows = profiling.summarize_trace(str(tmp_path / "trace"), top=5)
    assert rows and any("mm" in name for name, _, _ in rows)
    assert all(ms >= 0 and calls >= 1 for _, ms, calls in rows)
    assert profiling.host_memory_mb() > 10
    logger = tlog.setup_logger(str(tmp_path / "log"), name="eprecon_test")
    logger.info("hello")
    assert any(f.endswith(".log") for f in os.listdir(tmp_path / "log"))
    writer = tlog.SummaryWriter(str(tmp_path / "log"))
    writer.add_scalars("train", {"loss": torch.tensor(0.5)}, 3)
    writer.add_scalars("train", {"loss": 0.25}, 4)
    writer.close()
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        assert [json.loads(x) for x in f] == [
            {"mode": "train", "step": 3, "loss": 0.5},
            {"mode": "train", "step": 4, "loss": 0.25}]
