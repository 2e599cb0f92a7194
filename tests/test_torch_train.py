"""The training step, JAX against the port, on the tiny config
(__graft_entry__._tiny_cfg: 32^3 window at 12 cm) made threshold-free so
that every loss term is live: stage thresholds -100, occupancy-init
threshold 0, minimum voxel counts 1, a 1-layer 16-query 16-wide 4-head
decoder, instances of more than 20 voxels, 3 views at 48x64.

With running-statistics BatchNorm (no batch-statistics chaos) and the
JAX occupancy-init variance summed in f32 as the port sums it (ROADMAP.md,
known differences), the loss terms agree to 3e-2 of their value. Each
parameter's gradient (JAX's carried into the port's layout by
convert.tree_to_torch) is compared by cosine similarity wherever JAX's
norm exceeds 1e-3 of the largest leaf's (about 600 of 857 leaves): the
median is >= 0.99 and so is every leaf, with two listed exceptions, both
bf16 rounding amplified by cancellation (the two stacks round bf16 at
other places; their forwards agree to 3e-2):
  * the occupancy-init path (backbone2d, neucon_net.initialization),
    whose gradient is 2 (s_v - mean) / n of the cross-view variance, a
    difference of bf16 features that nearly cancels: >= 0.75 (lowest seen
    0.775-0.78; under half a grey level of image noise JAX's own gradient
    there falls to a lowest cosine of 0.70-0.82 over three draws);
  * other leaves, mostly biases and norm parameters of bf16 layers, whose
    gradient is a sum over thousands of voxels that cancels: >= 0.90, at
    most 20% of the compared leaves. The floor is JAX's own spread, not the
    port's: JAX against itself under half a grey level of image noise
    reaches 0.921-0.936 on these leaves (three noise draws, 69-85 of 611
    below 0.99; `jax_noise_cosines` at the end of this file measures it).
    The port's lowest depends on the host, whose XLA-CPU
    rounds JAX's bf16 at other places: 0.949 (17% below 0.99) on one
    host, 0.936 (82 of 611) on another, with and without the persistent
    compile cache.
The Trainer's own tests (batch statistics, optimizer, checkpoint) are
port-only: its optimizer is held against optax in test_torch_train_state.py.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from torch_parity import load, port_model_config, random_variables, to_np

from eprecon_tpu.data import synthetic as jsyn
from eprecon_tpu.models import occupancy_init as joi
from eprecon_tpu.ops import back_project as jbp
from eprecon_tpu.models.eprecon import (EPRecon, FragmentInputs,
                                        FragmentTargets)
from eprecon_tpu.models.eprecon import make_recurrent_state as jax_state
from eprecon_tpu.train.state import fragment_loss_fn
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.convert import tree_to_torch
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.models.layers import BatchNorm
from eprecon_tpu_torch.train import checkpoint as tck
from eprecon_tpu_torch.train.state import Trainer, fragment_tensors

VIEWS, HW = 3, (48, 64)
# parameters whose gradient reaches them only through the occupancy-init
# variance (the reconstruction backbone feeds nothing else)
INIT_PATH = ("backbone2d.", "neucon_net.initialization.")
TERMS = ("occupancy_initialization_loss", "tsdf_occ_loss_0", "tsdf_occ_loss_1",
         "tsdf_occ_loss_2", "panoptic_loss", "total_loss")


def _model_config():
    m = g._tiny_cfg().model
    pan = dataclasses.replace(m.panoptic, num_queries=16, dec_layers=1,
                              hidden_dim=16, nheads=4, min_instance_voxels=20)
    return dataclasses.replace(m, thresholds=(-100.0,) * 3,
                               occ_init_threshold=0.0, min_init_voxels=1,
                               min_stage_voxels=1, panoptic=pan)


def _jax_problem():
    """The fragment, the model's random variables and one JAX training
    step's loss terms and gradients as a function of the images."""
    m = _model_config()
    d = jsyn.make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                           voxel_size=m.voxel_size, seed=0)
    frag = FragmentInputs(jnp.asarray(d["proj_matrices"]),
                          jnp.asarray(d["vol_origin_partial"]),
                          jnp.asarray(d["world_to_aligned_camera"]),
                          jnp.zeros((m.n_layer, 3), jnp.int32))
    targets = FragmentTargets(tuple(jnp.asarray(x) for x in d["tsdf_levels"]),
                              tuple(jnp.asarray(x) for x in d["occ_levels"]),
                              jnp.asarray(d["semantic"]), jnp.asarray(d["instance"]))
    model = EPRecon(m, use_running_average=True)
    state = jax_state(m)
    variables = random_variables(model, jnp.asarray(d["imgs"]), frag, state,
                                 targets, seed=0)
    params = variables["params"]
    aux = {k: v for k, v in variables.items() if k != "params"}
    step = jax.jit(jax.value_and_grad(
        lambda p, a, i, f, t, r: fragment_loss_fn(model, p, a, i, f, t, r),
        has_aux=True))

    def run(imgs):
        (_, (metrics, _, _)), grads = step(params, aux, jnp.asarray(imgs),
                                           frag, targets, state)
        return to_np(metrics), to_np(grads)

    return m, d, variables, run


@pytest.fixture(scope="module")
def jax_step(f32_variance):
    """JAX loss terms and gradients of one fragment, computed once."""
    m, d, variables, run = _jax_problem()
    metrics, grads = run(d["imgs"])
    return dict(m=m, d=d, variables=variables, metrics=metrics, grads=grads)


_JAX_VARIANCE = jbp.back_project_variance


def _variance_in_f32(coords, valid, origin, voxel_size, feats, proj,
                     bp_backward="scatter"):
    var, count = _JAX_VARIANCE(coords, valid, origin, voxel_size,
                               feats.astype(jnp.float32), proj, bp_backward)
    return var.astype(feats.dtype), count


@pytest.fixture(scope="module")
def f32_variance():
    """The JAX occupancy init with its variance summed in f32, as the
    port sums it (in bf16, E[x^2] - E[x]^2 cancels: ROADMAP.md, known
    differences); the features and the result stay bf16."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joi, "back_project_variance", _variance_in_f32)
        yield


def _port_inputs(d, device="cpu"):
    return fragment_tensors(d, np.zeros((3, 3), np.int64), torch.device(device))


def test_losses_and_gradients_match_jax(jax_step):
    m = port_model_config(jax_step["m"])
    model = load(te.EPRecon(m, use_running_average=True), jax_step["variables"])
    imgs, frag, targets = _port_inputs(jax_step["d"])
    _, losses, _ = model(imgs, frag, te.make_recurrent_state(m), targets)
    want = jax_step["metrics"]
    assert float(want["frag_ok"]) == 1.0
    for k in TERMS:
        got = float(losses[k].detach())
        assert float(want[k]) > 0.1, k   # every term is live
        assert abs(got - float(want[k])) <= 3e-2 * abs(float(want[k])), (k, got, want[k])

    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses["total_loss"],
                                [p for _, p in model.named_parameters()],
                                allow_unused=True)
    got = dict(zip(names, grads))
    want = tree_to_torch(model, jax_step["grads"])
    assert set(want) == set(names)
    norms = {n: float(w.norm()) for n, w in want.items()}
    floor = 1e-3 * max(norms.values())
    cosines = {}
    for n, w in want.items():
        if norms[n] > floor:
            assert got[n] is not None, n
            cosines[n] = float((got[n] * w).sum() / (got[n].norm() * w.norm()))
    assert len(cosines) > 500
    low = {n: c for n, c in cosines.items() if c < 0.99}
    init = {n: c for n, c in low.items() if n.startswith(INIT_PATH)}
    other = {n: c for n, c in low.items() if n not in init}
    assert min(init.values(), default=1) >= 0.75, init
    assert min(other.values(), default=1) >= 0.90, other
    assert len(other) <= 0.2 * len(cosines), len(other)
    assert np.median(list(cosines.values())) >= 0.99


def _train_config(m):
    cfg = tconfig.Config(model=m)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, accumulation_steps=2))


def test_trainer_steps_with_batch_statistics(monkeypatch):
    """Trainer.step with batch-statistics BatchNorm, twice with the
    recurrent state threaded: finite, live losses; the running statistics
    move; the parameters move on the second (accumulated) micro-step only;
    the target maps fill; the compaction scores carry no gradient."""
    from eprecon_tpu_torch.ops import sparse as tsp

    m = port_model_config(_model_config())
    d = jsyn.make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                           voxel_size=m.voxel_size, seed=1)
    trainer = Trainer(_train_config(m), te.EPRecon(m, seed=3), device="cpu")
    scores = []
    compact = tsp.compact

    def recording(*args, score=None, **kw):
        scores.append(score is not None and score.requires_grad)
        return compact(*args, score=score, **kw)

    monkeypatch.setattr(tsp, "compact", recording)
    bns = [mod for mod in trainer.model.modules() if isinstance(mod, BatchNorm)]
    stats0 = [bn.running_mean.clone() for bn in bns]
    params0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    rec = trainer.recurrent_state()
    imgs, frag, targets = _port_inputs(d)
    for i in range(2):
        rec, metrics = trainer.step(imgs, frag, targets, rec)
        for k in TERMS:
            assert torch.isfinite(metrics[k]) and float(metrics[k]) > 0, k
        moved = any(not torch.equal(p, params0[n])
                    for n, p in trainer.model.named_parameters())
        assert moved == (i == 1)
        assert int(rec.tmaps[2].occ.sum()) > 0
    assert all(not torch.equal(bn.running_mean, s) for bn, s in zip(bns, stats0))
    assert scores and not any(scores)
    assert trainer.step_count == 2 and trainer.optimizer.updates == 1


def test_checkpoint_round_trip(tmp_path):
    """Save after one micro-step; a fresh trainer restored from it takes
    the same next step (parameters, optimizer state and running statistics
    bit-equal); restore_submodule loads one prefix only."""
    m = port_model_config(_model_config())
    d = jsyn.make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                           voxel_size=m.voxel_size, seed=2)
    imgs, frag, targets = _port_inputs(d)
    cfg = _train_config(m)
    a = Trainer(cfg, te.EPRecon(m, seed=4), device="cpu")
    rec, _ = a.step(imgs, frag, targets, a.recurrent_state())
    path = tck.save_checkpoint(str(tmp_path), 7, a)
    assert tck.latest_checkpoint(str(tmp_path)) == path
    rec_b = copy.deepcopy(rec)
    a.step(imgs, frag, targets, rec)
    b = tck.restore_checkpoint(path, Trainer(cfg, te.EPRecon(m, seed=5), device="cpu"))
    assert b.step_count == 1 and b.optimizer.mini_step == 1
    b.step(imgs, frag, targets, rec_b)
    assert b.optimizer.updates == a.optimizer.updates == 1
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), n
    saved = torch.load(path, weights_only=True)["model"]
    fresh = te.EPRecon(m, seed=6)
    before = {n: x.clone() for n, x in fresh.state_dict().items()}
    tck.restore_submodule(path, fresh, "neucon_net/initialization")
    for n, x in fresh.state_dict().items():
        want = saved[n] if n.startswith("neucon_net.initialization") else before[n]
        assert torch.equal(x, want), n


def test_only_init_trains_the_initialization():
    """`only_init`: the forward stops after the occupancy-init loss, which
    is the total; only the reconstruction backbone and the occupancy init
    (the modules that loss reaches) move on the update."""
    m = port_model_config(_model_config())
    d = jsyn.make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                           voxel_size=m.voxel_size, seed=3)
    cfg = tconfig.Config(model=m)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, accumulation_steps=1, only_init=True))
    trainer = Trainer(cfg, te.EPRecon(m, seed=7), device="cpu")
    params0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    rec0 = trainer.recurrent_state()
    rec, metrics = trainer.step(*_port_inputs(d), rec0)
    assert set(metrics) == {"occupancy_initialization_loss", "total_loss",
                            "overflow", "frag_ok"}
    assert float(metrics["total_loss"]) == float(metrics["occupancy_initialization_loss"]) > 0
    assert rec is rec0
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, params0[n]) or n.startswith(INIT_PATH), n
    assert any(not torch.equal(p, params0[n])
               for n, p in trainer.model.named_parameters()
               if n.startswith("neucon_net.initialization."))


def jax_noise_cosines(draws: int = 3, seed: int = 123):
    """Per draw of half a grey level of uniform image noise: the lowest
    cosine of JAX's gradient with the noise against JAX's without, over
    the "other" leaves that test_losses_and_gradients_match_jax compares,
    how many of them fall below 0.99, and the occupancy-init path's lowest.
    The test's floors come from these. Run from the repository's root:

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py
    """
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joi, "back_project_variance", _variance_in_f32)
        m, d, variables, run = _jax_problem()
        model = load(te.EPRecon(port_model_config(m), use_running_average=True),
                     variables)
        base = tree_to_torch(model, run(d["imgs"])[1])
        norms = {n: float(w.norm()) for n, w in base.items()}
        names = [n for n in base if norms[n] > 1e-3 * max(norms.values())]
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(draws):
            noisy = np.clip(d["imgs"] + rng.uniform(-0.5, 0.5, d["imgs"].shape),
                            0, 255).astype(np.float32)
            grads = tree_to_torch(model, run(noisy)[1])
            cos = {n: float((grads[n] * base[n]).sum()
                            / (grads[n].norm() * base[n].norm())) for n in names}
            other = [c for n, c in cos.items() if not n.startswith(INIT_PATH)]
            init = [c for n, c in cos.items() if n.startswith(INIT_PATH)]
            out.append((min(other), sum(c < 0.99 for c in other), min(init)))
        return out


if __name__ == "__main__":
    import os

    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0 "
                          "--xla_llvm_disable_expensive_passes=true")
    jax.config.update("jax_platforms", "cpu")
    for i, (lo, below, init) in enumerate(jax_noise_cosines()):
        print(f"noise draw {i}: other leaves' lowest cosine {lo:.4f} ({below} "
              f"below 0.99); occupancy-init path's lowest {init:.4f}")
