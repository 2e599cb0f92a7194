"""model.remat_mode in the port: read as the JAX package reads it, and a
transform of memory and time only.

Two training steps at a tiny config (__graft_entry__._micro_cfg's
decoder, a 32^3 window at 12 cm, 3 views at 96x128, threshold-free
selection, accumulation 2) from the same weights and fragments under
each mode: the first step's gradient of every
parameter, the losses, the parameters and Adam moments after the update,
and every BatchNorm running statistic are bitwise those of "none" (the
recompute re-runs the same ops on the same inputs and moves no running
statistics); a forward pre-hook on each boundary module shows which
modules the backward recomputed; a no_grad forward recomputes nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from torch_parity import one_torch_thread, port_model_config

from eprecon_tpu.config import default_config as jax_default_config
from eprecon_tpu.config import load_config as jax_load_config
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.data.synthetic import make_fragment, make_scene
from eprecon_tpu_torch.models.eprecon import (REMAT_3D, EPRecon,
                                              remat_boundaries)
from eprecon_tpu_torch.models.layers import update_running_stats
from eprecon_tpu_torch.train.state import Trainer, fragment_tensors

MODES = ("none", "light", "full")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(mode):
    m = dataclasses.replace(port_model_config(g._micro_cfg().model),
                            remat_mode=mode, n_vox=(32, 32, 32),
                            voxel_size=0.12, global_extent=(64, 64, 32),
                            voxel_capacity=(512, 4096, 32768),
                            thresholds=(-100.0,) * 3, occ_init_threshold=0.0,
                            min_init_voxels=1, min_stage_voxels=1)
    cfg = tconfig.default_config()
    return dataclasses.replace(cfg, model=m, train=dataclasses.replace(
        cfg.train, accumulation_steps=2))


def _boundary_modules(model):
    """The module each remat boundary wraps (the GRU fusions by their two
    ConvGRUs), by boundary name."""
    core = model.neucon_net
    n = core.cfg.n_layer
    return {
        "backbones": [model.backbone2d, model.backbone_occ_pano],
        "initialization": [core.initialization],
        "sp_conv": [getattr(core, f"sp_conv_{i}") for i in range(n)],
        "gru_conv": [m for i in range(n) for m in
                     (getattr(core, f"gru_fusion_{i}").gru_voxel,
                      getattr(core, f"gru_fusion_{i}").gru_img)],
        "panoptic": [core.panoptic]}


def _count_calls(model):
    """Forward pre-hooks on the boundary modules: calls by boundary name
    (a pre-hook fires when a recompute starts, even one that stops early)."""
    calls = {k: 0 for k in ("backbones", *REMAT_3D)}
    for name, mods in _boundary_modules(model).items():
        for mod in mods:
            mod.register_forward_pre_hook(
                lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    return calls


def _frags(m):
    return [fragment_tensors(make_fragment(
        n_views=3, image_hw=(96, 128), n_vox=m.n_vox, voxel_size=m.voxel_size,
        seed=3 + i), np.zeros((3, 3), np.int64),
        torch.device("cpu")) for i in range(2)]


def _two_steps(mode):
    cfg = _cfg(mode)
    tr = Trainer(cfg, EPRecon(cfg.model, seed=3), device="cpu")
    calls = _count_calls(tr.model)
    rec = tr.recurrent_state()
    out = dict(losses=[])
    for i, (imgs, frag, targets) in enumerate(_frags(cfg.model)):
        before = dict(calls)
        rec, metrics = tr.step(imgs, frag, targets, rec)
        out["losses"].append({k: v.clone() for k, v in metrics.items()})
        if i == 0:  # the accumulator holds step 0's gradients
            out["grads"] = {k: a.clone() for k, a in tr.optimizer.acc.items()}
            out["calls"] = {k: calls[k] - before[k] for k in calls}
    assert tr.optimizer.updates == 1
    out["params"] = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    out["moments"] = {k: (tr.optimizer.mu[k], tr.optimizer.nu[k])
                      for k in tr.optimizer.mu}
    out["buffers"] = {k: b.clone() for k, b in tr.model.named_buffers()}
    return out


@pytest.fixture(scope="module")
def plain_run():
    return _two_steps("none")


@pytest.mark.parametrize("mode", MODES)
def test_remat_modes_give_the_same_step(plain_run, mode):
    """Gradients, losses, the update and the running statistics equal
    "none"'s bit for bit; the boundaries `mode` names ran twice in step 0
    (forward and recompute), the others once."""
    got = plain_run if mode == "none" else _two_steps(mode)
    want = plain_run
    twice = set(remat_boundaries(mode))
    per_boundary = {"backbones": 2, "initialization": 1, "sp_conv": 3,
                    "gru_conv": 6, "panoptic": 1}
    assert got["calls"] == {k: n * (2 if k in twice else 1)
                            for k, n in per_boundary.items()}
    assert got["grads"].keys() == want["grads"].keys()
    for k, a in got["grads"].items():
        assert torch.equal(a, want["grads"][k]), k
    nonzero = sum(bool(a.abs().max() > 0) for a in got["grads"].values())
    assert nonzero > 0.9 * len(got["grads"])
    assert all(float(x["frag_ok"]) == 1 for x in got["losses"])
    for step, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (step, k)
    for k in ("params", "buffers"):
        for name, t in got[k].items():
            assert torch.equal(t, want[k][name]), name
    for name, (mu, nu) in got["moments"].items():
        assert torch.equal(mu, want["moments"][name][0]), name
        assert torch.equal(nu, want["moments"][name][1]), name
    stats = [b for n, b in got["buffers"].items() if n.endswith("running_mean")]
    assert stats and any(bool(b.abs().max() > 0) for b in stats)


def test_no_grad_forward_recomputes_nothing():
    """Under no_grad (streaming inference, export) "full" calls each
    boundary module once, as a plain forward does."""
    cfg = _cfg("full")
    model = EPRecon(cfg.model, seed=3).train()
    calls = _count_calls(model)
    imgs, frag, _ = _frags(cfg.model)[0]
    with torch.no_grad():
        model(imgs, frag, Trainer(cfg, model, device="cpu").recurrent_state())
    assert calls == {"backbones": 2, "initialization": 1, "sp_conv": 3,
                     "gru_conv": 6, "panoptic": 1}


def test_recompute_leaves_running_statistics():
    """update_running_stats moves a BatchNorm's statistics once, in the
    forward; inside a recompute it leaves them, so a backward through a
    recomputed BatchNorm gives the statistics of the forward alone."""
    from eprecon_tpu_torch.models.layers import BatchNorm, remat

    torch.manual_seed(0)
    x = torch.randn(6, 5, requires_grad=True)
    plain, recomputed = BatchNorm(5).train(), BatchNorm(5).train()
    plain(x).square().sum().backward()
    want_grad = x.grad.clone()
    x.grad = None
    remat(recomputed, x).square().sum().backward()
    assert torch.equal(x.grad, want_grad)
    assert torch.equal(recomputed.running_mean, plain.running_mean)
    assert torch.equal(recomputed.running_var, plain.running_var)
    before = plain.running_mean.clone()
    update_running_stats(plain, torch.ones(5), torch.ones(5))
    assert not torch.equal(plain.running_mean, before)


@pytest.mark.parametrize("value", ["none", "light", "full", "remat_everything"])
def test_remat_mode_reads_as_jax(value, tmp_path):
    """remat_mode is a leaf both configs share, with JAX's default; a YAML
    value loads to the same string in both, and gives the boundaries the
    JAX package's two tests of it give (eprecon.py:206 `== "full"` for the
    3-D modules, :510 `== "none"` for the backbones): an unknown string
    reads as "light"."""
    assert tconfig.default_config().model.remat_mode == \
        jax_default_config().model.remat_mode == "light"
    path = tmp_path / "remat.yaml"
    path.write_text(f"model:\n  remat_mode: {value}\n")
    port = tconfig.load_config(str(path)).model.remat_mode
    assert port == jax_load_config(str(path)).model.remat_mode == value
    jax_3d, jax_backbones = value == "full", value != "none"
    assert remat_boundaries(port) == (
        (("backbones",) if jax_backbones else ()) + (REMAT_3D if jax_3d else ()))
    if value not in ("none", "full"):
        assert remat_boundaries(port) == remat_boundaries("light")
