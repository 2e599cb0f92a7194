"""The fragment forward as a serving artifact (`eprecon_tpu_torch/inference/
export.py`, `serving.py`), the counterpart of tests/test_export.py at its
tiny sizes, held against the eager port (`pipeline.fragment_forward`,
which tests/test_torch_forward.py holds against JAX).

One export serves every case: the graph names the back-projection kernels
as `eprecon_tpu_torch::` custom ops (the tracer saw them); two fragments
at different window origins run through the one program; swapped weights
match the live path on them; and a process that refuses the model code
loads the saved artifact and serves the fragments (`chip_smoke.py
--serve-artifact`). Tolerances are tests/test_export.py's: tsdf_window
1e-5, pred_logits 1e-4, the maps equal. The four custom ops pass
`torch.library.opcheck` on CPU tensors.
"""
import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread

from eprecon_tpu_torch.config import default_config
from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
from eprecon_tpu_torch.fragment_io import FragmentInputs
from eprecon_tpu_torch.inference import export as ex
from eprecon_tpu_torch.inference import serving
from eprecon_tpu_torch.inference.pipeline import fragment_forward
from eprecon_tpu_torch.models.eprecon import EPRecon, make_recurrent_state
from eprecon_tpu_torch.models.gru_fusion import PanopticGlobalDense
from eprecon_tpu_torch.ops import back_project as bp

REPO = Path(__file__).resolve().parents[1]
# window origins per stage (coarse -> fine) of the two fragments
RELS = (np.zeros((3, 3), np.int64), np.array([[2, 1, 0], [4, 2, 0], [8, 4, 0]]))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _tiny():
    cfg = default_config()
    m = dataclasses.replace(
        cfg.model, n_vox=(32, 32, 32), voxel_size=0.12,
        voxel_capacity=(512, 2048, 8192), global_extent=(64, 64, 32),
        min_init_voxels=100, min_stage_voxels=50)
    cfg = dataclasses.replace(cfg, model=m)
    d = make_fragment(n_views=4, image_hw=(96, 128), n_vox=m.n_vox,
                      voxel_size=m.voxel_size, seed=0, scene=make_scene(0))
    frags = [FragmentInputs(torch.as_tensor(d["proj_matrices"]),
                            torch.as_tensor(d["vol_origin_partial"]),
                            torch.as_tensor(d["world_to_aligned_camera"]),
                            torch.as_tensor(rel)) for rel in RELS]
    return cfg, torch.as_tensor(d["imgs"]), frags


def _serve(program, cfg, imgs, frags):
    """Outputs and maps after each fragment, on empty maps."""
    rec = make_recurrent_state(cfg.model)
    pmap = PanopticGlobalDense.empty(cfg.model.global_extent)
    steps = []
    for frag in frags:
        with torch.no_grad():
            out, _, rec, pmap = program(imgs, frag, rec, pmap)
        steps.append((out, [(g.feats.clone(), g.mask.clone()) for g in rec.gmaps],
                      {k: getattr(pmap, k).clone() for k in
                       ("tsdf", "instance", "semantic", "mask",
                        "next_instance_id")}))
    return steps


def _assert_same(got, want):
    for (go, gmaps, gp), (wo, wmaps, wp) in zip(got, want, strict=True):
        torch.testing.assert_close(go["tsdf_window"], wo["tsdf_window"],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(go["pred_logits"], wo["pred_logits"],
                                   rtol=1e-4, atol=1e-4)
        for (gf, gm), (wf, wm) in zip(gmaps, wmaps, strict=True):
            assert torch.equal(gf, wf) and torch.equal(gm, wm)
        for k in wp:
            assert torch.equal(gp[k], wp[k]), k


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny config's program exported on the CPU and saved, and the
    process that serves it from disk started at once (it loads while the
    other tests run)."""
    with one_torch_thread():
        cfg, imgs, frags = _tiny()
        model = EPRecon(cfg.model, seed=0)
        ep = ex.export_fragment_forward(cfg, model, imgs, frags[0], device="cpu")
        work = tmp_path_factory.mktemp("artifact")
        ex.save_serving_artifact(work / "fragment_forward.pt2", ep)
        torch.save({"device": "cpu", "fragments": [dict(frag._asdict(), imgs=imgs, reset=False,
                                       snapshot=True) for frag in frags]},
                   work / "requests.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--serve-artifact",
         str(work / "fragment_forward.pt2"), str(work / "requests.pt"),
         str(work / "results.pt")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield dict(cfg=cfg, imgs=imgs, frags=frags, model=model, ep=ep, work=work,
               proc=proc)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def live(exported):
    """The eager port on the two fragments, threading the maps."""
    with one_torch_thread():
        return _serve(lambda *a: fragment_forward(exported["model"],
                                                  exported["cfg"], *a),
                      exported["cfg"], exported["imgs"], exported["frags"])


def test_graph_names_the_kernels_as_custom_ops(exported):
    """The tracer recorded the back-projection kernels: the occupancy
    init's variance and the three stages' window means."""
    assert collections.Counter(serving.custom_op_nodes(exported["ep"])) == {
        "eprecon_tpu_torch.window_mean.default": 3,
        "eprecon_tpu_torch.variance_window.default": 1}


def test_one_artifact_serves_two_positions(exported, live):
    """Fragments at two window origins, through one program, equal the
    eager port: outputs, recurrent maps and panoptic map."""
    program = exported["ep"].module()
    got = _serve(program, exported["cfg"], exported["imgs"], exported["frags"])
    _assert_same(got, live)
    # the second fragment added to the map
    assert live[1][2]["mask"].sum() > live[0][2]["mask"].sum()


def test_swapped_weights_match_the_live_path(exported):
    """Another checkpoint loaded into the program serves as the live path
    on those weights."""
    program = exported["ep"].module()
    cfg, imgs, frags = exported["cfg"], exported["imgs"], exported["frags"][1:]
    swap = EPRecon(cfg.model, seed=2)
    program.load_state_dict(swap.state_dict())
    want = _serve(lambda *a: fragment_forward(swap, cfg, *a), cfg, imgs, frags)
    _assert_same(_serve(program, cfg, imgs, frags), want)


def test_initial_state_is_the_live_empty_state(exported):
    rec, pmap = serving.initial_state(exported["ep"])
    cfg = exported["cfg"]
    want = make_recurrent_state(cfg.model)
    for a, b in zip(rec.gmaps + rec.tmaps, want.gmaps + want.tmaps, strict=True):
        for x, y in zip(vars(a).values(), vars(b).values()):
            assert x.dtype == y.dtype and torch.equal(x, y)
    empty = PanopticGlobalDense.empty(cfg.model.global_extent)
    for k, v in vars(empty).items():
        assert torch.equal(getattr(pmap, k), v), k


def test_served_from_disk_without_the_model_code(exported, live):
    """The saved artifact, loaded by a process that refuses
    eprecon_tpu_torch.models, serves the fragments as the eager port."""
    out, err = exported["proc"].communicate(timeout=600)
    assert exported["proc"].returncode == 0, err[-4000:]
    res = torch.load(exported["work"] / "results.pt")
    assert res["model_modules"] == []
    assert res["custom_ops"] == ["eprecon_tpu_torch.variance_window.default",
                                 "eprecon_tpu_torch.window_mean.default"]
    assert res["launches"] == {}  # CPU tensors take the plain versions
    for got, (want, _, _) in zip(res["outputs"], live, strict=True):
        torch.testing.assert_close(got["tsdf_window"], want["tsdf_window"],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["pred_logits"], want["pred_logits"],
                                   rtol=1e-4, atol=1e-4)
    for snap, (_, _, wmap) in zip(res["snapshots"], live, strict=True):
        assert torch.equal(snap["instance"], wmap["instance"])
        assert torch.equal(snap["semantic"], wmap["semantic"])


def _op_args(op):
    g = torch.Generator().manual_seed(0)
    v, h, w, c = 3, 12, 16, 8
    feats = torch.randn(v, 1, h, w, c, generator=g).to(torch.bfloat16)
    k = np.array([[10.0, 0, 8], [0, 10, 6], [0, 0, 1]])
    proj = []
    for i in range(v):
        p = np.eye(4)
        p[:3, :3] = k
        p[:3, 3] = k @ np.array([-0.2 * i, -0.1, 1.5])
        proj.append(p)
    proj = torch.tensor(np.stack(proj), dtype=torch.float32)[:, None]
    origin = torch.tensor([[-0.3, -0.3, -0.3]])
    coords = torch.cat([torch.zeros(20, 1, dtype=torch.int32),
                        torch.randint(0, 6, (20, 3), generator=g,
                                      dtype=torch.int32)], 1)
    valid = torch.ones(20, dtype=torch.bool)
    _, count = bp.back_project_window((4, 4, 4), 1, origin, 0.1, feats, proj)
    _, var_count = bp.back_project_variance(coords, valid, origin, 0.1, feats,
                                            proj)
    _, win_count = bp.back_project_variance_window((3, 4, 5), 2, origin, 0.1,
                                                   feats, proj)
    return {
        "window_mean": (feats.float().requires_grad_(), origin, proj,
                        [4, 4, 4], 1, 0.1),
        "window_mean_backward": (torch.randn(4, 4, 4, c, generator=g)
                                 .to(torch.bfloat16), origin, proj, count,
                                 [4, 4, 4], 1, 0.1, h, w),
        "variance": (feats.float().requires_grad_(), coords, valid, origin,
                     proj, 0.1),
        "variance_backward": (feats, coords, valid, origin, proj, var_count,
                              torch.randn(20, c, generator=g), 0.1),
        "variance_window": (feats.float().requires_grad_(), origin, proj,
                            [3, 4, 5], 2, 0.1),
        "variance_window_backward": (feats, origin, proj, win_count,
                                     torch.randn(60, c, generator=g), [3, 4, 5],
                                     2, 0.1),
    }[op]


@pytest.mark.parametrize("op", ["window_mean", "window_mean_backward",
                                "variance", "variance_backward",
                                "variance_window", "variance_window_backward"])
def test_custom_op_passes_opcheck(op):
    torch.library.opcheck(getattr(torch.ops.eprecon_tpu_torch, op).default,
                          _op_args(op))
