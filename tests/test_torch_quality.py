"""The port's closed quality loop (eprecon_tpu_torch/tools/quality_utils.py,
tools/quality_run.py) held against the JAX package's
(tests/quality_utils.py, tests/test_quality_loop.py, tests/test_quality_pq.py):
the tiny config, the scene and its fragments, the GT fused on the
reconstructed grid and the score of a reconstruction, each on the same
inputs; a short training run through the harness; and the port's fresh
initialisation against the initialisers the flax modules name.

The trained floors (`test_trained_quality_floors_port`) are runs of three
seeds x 100 training steps: `slow` on the CPU (~15 min), `cuda` and
`quality_pq` on the card. The card has no JAX, so the JAX package is
imported inside the parity tests, and on the card this module runs with
`--noconftest -m "cuda and quality_pq"`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from eprecon_tpu_torch.inference.pipeline import SceneResult
from eprecon_tpu_torch.models.eprecon import EPRecon
from eprecon_tpu_torch.tools import quality_run
from eprecon_tpu_torch.tools import quality_utils as tq
from eprecon_tpu_torch.train.state import Trainer

SCORE_KEYS = ("fscore", "prec", "recal", "dist1", "dist2", "window_fscore",
              "window_prec", "window_recal", "PQ", "SQ", "RQ", "tp", "fp",
              "fn", "n_pred_inst", "n_gt_inst")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, fragments), (port scene, fragments) of the quality
    loop's defaults."""
    from tests import quality_utils as jq

    jcfg, tcfg = jq.tiny_cfg(), tq.tiny_cfg()
    js, jf, _ = jq.build_scene_and_fragments(jcfg)
    ts, tf, _ = tq.build_scene_and_fragments(tcfg)
    return (js, jf), (ts, tf)


def _grid(frags, vsz):
    """A grid over every fragment's window, one window wide of margin in
    x and y below and above."""
    lo = np.min([d["vol_origin_partial"] for d in frags], 0) - 2 * vsz
    hi = np.max([d["vol_origin_partial"] for d in frags], 0)
    hi = hi + np.asarray(frags[0]["tsdf_levels"][0].shape) * vsz + 2 * vsz
    dim = tuple(int(x) for x in np.ceil((hi - lo) / vsz))
    return lo.astype(np.float32), dim


def test_tiny_cfg_matches_jax():
    """The port's tiny_cfg is the JAX package's, field by field: the model
    through torch_parity.port_model_config, and every train field the
    port keeps."""
    from tests import quality_utils as jq
    from torch_parity import port_model_config

    j, t = jq.tiny_cfg(), tq.tiny_cfg()
    assert t.model == port_model_config(j.model)
    for f in dataclasses.fields(t.train):
        assert getattr(t.train, f.name) == getattr(j.train, f.name), f.name
    assert (t.train.lr, t.train.accumulation_steps) == (1e-3, 1)
    assert t.model.occ_init_threshold == 0.05


def test_scene_and_fragments_match_jax(scenes):
    """The boxes, images, projections, the aligned-camera transform and
    origins equal JAX's within 1e-5, the TSDF levels within 1e-5, and
    occupancy and labels exactly (no voxel of this scene's fragments
    lands on the other side of a pixel-rounding boundary)."""
    (js, jf), (ts, tf) = scenes
    assert [b.instance for b in ts.boxes] == [b.instance for b in js.boxes]
    for b_t, b_j in zip(ts.boxes, js.boxes):
        np.testing.assert_allclose(b_t.lo, b_j.lo, atol=1e-6)
        np.testing.assert_allclose(b_t.hi, b_j.hi, atol=1e-6)
        assert b_t.cls == b_j.cls
    assert len(tf) == len(jf) == 3
    for i, (got, want) in enumerate(zip(tf, jf)):
        for k in ("imgs", "depths", "poses", "intrinsics", "proj_matrices",
                  "vol_origin_partial", "world_to_aligned_camera"):
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       atol=1e-5, rtol=1e-6,
                                       err_msg=f"fragment {i} {k}")
        for lvl in range(3):
            np.testing.assert_allclose(
                got["tsdf_levels"][lvl], np.asarray(want["tsdf_levels"][lvl]),
                atol=1e-5, rtol=0, err_msg=f"fragment {i} tsdf {lvl}")
            np.testing.assert_array_equal(
                got["occ_levels"][lvl], np.asarray(want["occ_levels"][lvl]))
        for k in ("semantic", "instance"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"fragment {i} {k}")
        assert got["occ_levels"][0].sum() > 500


def test_gt_on_grid_matches_jax(scenes):
    """The GT fused from all 15 views on one grid over the scene equals
    JAX's: tsdf within 1e-5, occupancy and labels exactly."""
    from tests import quality_utils as jq

    (js, jf), (ts, tf) = scenes
    origin, dim = _grid(tf, 0.12)
    got = tq.gt_on_grid(ts, tf, origin, dim, 0.12)
    want = [np.asarray(x) for x in jq.gt_on_grid(js, jf, origin, dim, 0.12)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    for g, w, name in zip(got[1:], want[1:], ("occ", "semantic", "instance")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[1].sum() > 1000 and len(np.unique(got[3])) >= 4


def _perturbed_result(scene, frags):
    """A reconstruction made from the GT with fixed faults: the TSDF
    shifted by one voxel in x and 0.2 in value, the floor instance split
    in two, and one box relabelled to another class."""
    origin, dim = _grid(frags, 0.12)
    t, occ, sem, ins = tq.gt_on_grid(scene, frags, origin, dim, 0.12)
    tsdf = np.clip(np.roll(t, 1, axis=0) + 0.2, -1, 1).astype(np.float32)
    ins, sem = ins.copy(), sem.copy()
    floor = ins == 2
    half = np.zeros_like(floor)
    half[: dim[0] // 2] = True
    ins[floor & half] = 9
    box = scene.boxes[0]
    sem[ins == box.instance] = 1 if box.cls != 1 else 3
    return SceneResult("s", origin, 0.12, tsdf, ins.astype(np.int32),
                       sem.astype(np.int32))


def _jax_score(result, scene, frags, cfg):
    """score_vs_gt's steps (tests/quality_utils.py:121-175) and the window
    F-score (tests/test_quality_loop.py:56-79) with the JAX package's
    functions, on an already reconstructed result."""
    from eprecon_tpu.inference.mesh_export import marching_cubes
    from eprecon_tpu.tools.evaluation_utils import (eval_mesh,
                                                    panoptic_quality,
                                                    transfer_labels_to_gt)
    from tests import quality_utils as jq

    out, vsz = result, float(result.voxel_size)
    gt_tsdf, gt_occ, gt_sem, gt_ins = [np.asarray(x) for x in jq.gt_on_grid(
        scene, frags, out.origin, out.tsdf.shape, vsz)]
    pv, _, _ = marching_cubes(out.tsdf)
    gv, _, _ = marching_cubes(gt_tsdf)
    m = dict(eval_mesh(pv * vsz + out.origin, gv * vsz + out.origin,
                       threshold=0.15, down_sample=0.06))
    gt_verts = [marching_cubes(np.asarray(d["tsdf_levels"][0]))[0]
                * cfg.model.voxel_size + d["vol_origin_partial"] for d in frags]
    mw = eval_mesh(pv * vsz + out.origin, np.concatenate(gt_verts),
                   threshold=0.15, down_sample=0.06)
    m.update(window_fscore=mw["fscore"], window_prec=mw["prec"],
             window_recal=mw["recal"])
    sel3 = gt_occ & (gt_ins > 0)
    ps, pi = transfer_labels_to_gt(out.semantic, out.instance, out.origin,
                                   sel3, out.origin, vsz)
    gt_i, gt_s = gt_ins[sel3], gt_sem[sel3]
    m["n_gt_inst"] = int(len(np.setdiff1d(np.unique(gt_i), [0])))
    m["n_pred_inst"] = int(len(np.setdiff1d(np.unique(out.instance), [0])))

    def cls_map(seg, sem):
        return {int(i): int(np.bincount(sem[seg == i]).argmax())
                for i in np.setdiff1d(np.unique(seg), [0])}

    m.update(panoptic_quality(pi, cls_map(pi, ps), gt_i, cls_map(gt_i, gt_s)))
    return m


def test_score_result_matches_jax(scenes):
    """score_result gives the JAX package's metrics within 1e-4 on the
    same perturbed reconstruction, and the perturbation shows: the split
    and the relabelling cost PQ, the shift costs F-score."""
    from tests import quality_utils as jq

    (js, jf), (ts, tf) = scenes
    result = _perturbed_result(ts, tf)
    got = tq.score_result(result, ts, tf)
    want = _jax_score(result, js, jf, jq.tiny_cfg())
    for k in SCORE_KEYS:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, got[k], want[k])
    assert 0 < got["PQ"] < 0.9 and got["fp"] >= 1 and got["fn"] >= 1
    assert 0 < got["fscore"] < 1 and got["n_gt_inst"] == 4
    empty = dataclasses.replace(result, tsdf=np.ones_like(result.tsdf))
    assert tq.score_result(empty, ts, tf)["n_gt_inst"] == -1


def test_train_and_score_short_run(monkeypatch):
    """Four steps through the harness on the CPU: finite losses read back
    at the reported steps only, a fresh recurrent state at steps 0 and 3
    (each cycle over the three fragments), scores in [0, 1], and no kernel
    launch on the CPU."""
    fresh_at = []
    orig = Trainer.recurrent_state

    def recording(self):
        fresh_at.append(self.step_count)
        return orig(self)

    monkeypatch.setattr(Trainer, "recurrent_state", recording)
    run = quality_run.train_and_score(tq.tiny_cfg(), 4, score_at=(4,),
                                      seed=0, device="cpu",
                                      report_at=(0, 3))
    assert fresh_at == [0, 3]
    assert sorted(run["losses"]) == [0, 3]
    for terms in run["losses"].values():
        assert all(np.isfinite(v) for v in terms.values()), terms
        assert terms["total_loss"] > 0
    m = run["scores"][4]
    for k in ("fscore", "prec", "recal", "window_fscore", "window_prec",
              "window_recal", "PQ", "SQ", "RQ"):
        assert 0.0 <= m[k] <= 1.0, (k, m[k])
    assert run["launches"] == [(0, 0)] * 4 and run["ms_per_step"] > 0


def _flax_initialisers(cfg, frag):
    """[(flax variable path, shape, initialiser)] of every parameter the
    JAX package's EPRecon creates, recorded while tracing its init on
    `frag` for shapes (compiling the init costs minutes on the CPU)."""
    import flax.linen as fnn
    import jax

    from eprecon_tpu.models.eprecon import EPRecon as JaxEPRecon
    from eprecon_tpu.models.eprecon import make_recurrent_state
    from eprecon_tpu.train.loop import _scene_origin, fragment_to_device_args

    sample = dict(imgs=frag["imgs"], proj_matrices=frag["proj_matrices"],
                  vol_origin=frag["vol_origin_partial"],
                  vol_origin_partial=frag["vol_origin_partial"],
                  world_to_aligned_camera=frag["world_to_aligned_camera"])
    a = fragment_to_device_args(cfg, sample, _scene_origin(cfg, sample))
    made = []
    param = fnn.Module.param

    def recording(self, name, init_fn, *args, **kw):
        made.append((self.scope.path + (name,), tuple(args[0]), init_fn))
        return param(self, name, init_fn, *args, **kw)

    fnn.Module.param = recording
    try:
        jax.eval_shape(lambda: JaxEPRecon(cfg.model).init(
            jax.random.PRNGKey(0), a[0], a[1], make_recurrent_state(cfg.model),
            a[2]))
    finally:
        fnn.Module.param = param
    return made


def _initialiser_stats(init_fn, shape):
    """(mean, std, constant) of the values `init_fn` draws for `shape`:
    variance_scaling (xavier, lecun) from its fans, normal(stddev), or the
    constant of zeros / ones."""
    from jax._src.nn.initializers import _compute_fans

    cells = dict(zip(init_fn.__code__.co_freevars,
                     (c.cell_contents for c in init_fn.__closure__ or ())))
    if {"scale", "mode", "in_axis"} <= set(cells):
        fan_in, fan_out = _compute_fans(shape, cells["in_axis"],
                                        cells["out_axis"], cells["batch_axis"])
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2}[cells["mode"]]
        return 0.0, float(np.sqrt(cells["scale"] / denom)), None
    if set(cells) == {"stddev"}:
        return 0.0, float(cells["stddev"]), None
    const = {"zeros": 0.0, "ones": 1.0}.get(init_fn.__name__)
    assert const is not None, f"unknown initialiser {init_fn}"
    return const, 0.0, const


def test_initialisation_matches_flax(scenes):
    """Every parameter leaf of the port's fresh EPRecon(seed=0) is drawn
    as the initialiser its flax module names would draw it, evaluated on
    the leaf's shape: its std within 15% of the initialiser's and its mean
    within 0.1 of that std. For a leaf of n values the sampling error of
    one draw (3 standard errors: 3 sqrt(1 / 2n) of the std, 3 / sqrt(n)
    std of the mean) widens those bounds; from 900 values on it stays
    inside them. A constant leaf (norm scales 1, biases 0) is equal
    exactly."""
    from eprecon_tpu_torch.convert import tree_to_torch
    from tests import quality_utils as jq

    (_, jf), _ = scenes
    made = _flax_initialisers(jq.tiny_cfg(), jf[0])
    tree = {}
    for i, (path, shape, _) in enumerate(made):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.full(shape, i, np.float32)
    model = EPRecon(tq.tiny_cfg().model, seed=0)
    index = {name: int(t.reshape(-1)[0])
             for name, t in tree_to_torch(model, tree).items()}
    assert set(index) == {n for n, _ in model.named_parameters()}
    bad = []
    for name, w in model.named_parameters():
        _, shape, init_fn = made[index[name]]
        mean, std, const = _initialiser_stats(init_fn, shape)
        got = w.detach().numpy()
        if const is not None:
            if not (got == const).all():
                bad.append(f"{name}: not all {const}")
            continue
        n = got.size
        tol_std = max(0.15, 3 * np.sqrt(1 / (2 * n)))
        tol_mean = max(0.1, 3 / np.sqrt(n)) * std
        if abs(got.std() / std - 1) > tol_std or abs(got.mean() - mean) > tol_mean:
            bad.append(f"{name} {got.shape}: std {got.std():.4g} mean "
                       f"{got.mean():.4g}, the initialiser's {std:.4g} / {mean}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("device", [
    pytest.param("cpu", marks=pytest.mark.slow),
    pytest.param("cuda", marks=[pytest.mark.cuda, pytest.mark.quality_pq])])
def test_trained_quality_floors_port(device):
    """The JAX package's trained floors over the port's seeds 0-2, 100
    steps each: finite losses, every seed's loss at step 47 below 0.7 x
    its step-0 loss, and the median over the seeds above window F-score
    0.5 after 48 steps and above F-score 0.4, one predicted instance and
    PQ 0.25 after 100 (quality_run.floor_failures). On the card, every
    step launches the forward and backward kernels."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, bad = quality_run.run_seeds(tq.tiny_cfg(), (0, 1, 2), device=device)
    assert not bad, bad


def test_quality_run_cli_deterministic(capsys):
    """The CLI, one step on the CPU with torch's deterministic algorithms
    on: each seed's lines, the score after the last step, `checks: pass`
    and exit code 0."""
    before = torch.are_deterministic_algorithms_enabled()
    try:
        rc = quality_run.main(["1", "1", "--seeds", "0", "--device", "cpu",
                               "--deterministic"])
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(before)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "seed 0 loss 0:" in out and "seed 0 after 1: fscore" in out, out
    assert out.rstrip().endswith("checks: pass"), out
