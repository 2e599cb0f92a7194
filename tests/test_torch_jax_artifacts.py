"""What the JAX package writes, read by the port: every key of its config
(as overrides and as YAML), its orbax training checkpoints in the three
optimizer layouts that create_train_state builds (MultiSteps, MultiSteps
under finetune_layer's mask, accumulation 1 without MultiSteps), through
restore_checkpoint / restore_model / restore_submodule, the CLI's loadckpt
and resume and the importer tool, and its mid-scene sessions
(save_session). On the tiny config (__graft_entry__._tiny_cfg).

The checkpoints hold a part of EPRecon under its own names (PART: the 2D
backbone's first layers, which finetune_layer 'init' freezes, and the fine
stage's up-sampling and TSDF head: convolutions, grouped ones, batch
norms, a transposed convolution, dense layers and layer norms): its flax
tree comes from random_variables of the JAX modules that hold it, and the
CLI builds that part in place of the whole model. Tracing the whole
model's init and running optax over its 857 leaves would cost the suite
most of a minute; what the part leaves out (every other module's
layout) is held by the forward and training tests, which load the whole
model's flax tree through the same convert.variables_to_torch.
"""
import copy
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as fnn

import __graft_entry__ as g
from chip_smoke import write_jax_session
from torch_parity import one_torch_thread, port_model_config, random_variables, to_np

from eprecon_tpu.config import default_config as jax_default_config
from eprecon_tpu.config import load_config as jax_load_config
from eprecon_tpu.inference.pipeline import StreamingReconstructor as JaxStreaming
from eprecon_tpu.models.backbone import MnasMulti
from eprecon_tpu.models.blocks import Linear4xTrans
from eprecon_tpu.models.eprecon import EPRecon, FragmentInputs
from eprecon_tpu.models.eprecon import make_recurrent_state as jax_state
from eprecon_tpu.models.gru_fusion import PanopticGlobalDense as JaxPanoptic
from eprecon_tpu.train.checkpoint import save_checkpoint as jax_save
from eprecon_tpu.models.unet_dense import DenseUNet
from eprecon_tpu.train.state import TrainState, freeze_mask_for, make_optimizer
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch import main as tmain
from eprecon_tpu_torch.convert import tree_to_torch, variables_to_torch
from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.tools import import_jax_checkpoint as ij
from eprecon_tpu_torch.train import checkpoint as tck
from eprecon_tpu_torch.train import loop as tloop
from eprecon_tpu_torch.train.state import Trainer

REPO = Path(__file__).resolve().parents[1]
STEP_TOL = 1e-6    # the next update, relative to its largest entry
LAYOUTS = {"multisteps": dict(accumulation_steps=2),
           "masked": dict(accumulation_steps=2, finetune_layer="init"),
           "no_multisteps": dict(accumulation_steps=1)}
# the tiny config as KEY VALUE overrides of config/{train,test}.yaml
TINY = ["model.n_vox", "[32,32,32]", "model.voxel_size", "0.12",
        "model.voxel_capacity", "[512,2048,8192]",
        "model.global_extent", "[64,64,32]", "model.min_init_voxels", "100",
        "model.min_stage_voxels", "50"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, vol, mask, head_in):
        return (DenseUNet(cr=0.25, use_running_average=True, name="sp_conv_2")(vol, mask),
                Linear4xTrans(1, name="tsdf_pred_2")(head_in))


class _JaxModules(fnn.Module):
    """EPRecon's backbone2d, neucon_net.sp_conv_2 and neucon_net.tsdf_pred_2
    (eprecon_tpu/models/eprecon.py), under its names."""

    @fnn.compact
    def __call__(self, imgs, vol, mask, head_in):
        return (MnasMulti(1.0, True, name="backbone2d")(imgs),
                _JaxNet(name="neucon_net")(vol, mask, head_in))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, the random flax variables of PART, the port's EPRecon
    whose modules PART copies)."""
    cfg = g._tiny_cfg()
    full = te.EPRecon(port_model_config(cfg.model))
    vol_ch = full.neucon_net.sp_conv_2.stem_conv.Conv_0.weight.shape[1]
    head_ch = full.neucon_net.tsdf_pred_2.Dense_0.weight.shape[1]
    v = random_variables(_JaxModules(), jnp.zeros((2, 32, 48, 3)),
                         jnp.zeros((8, 8, 8, vol_ch)), jnp.ones((8, 8, 8), bool),
                         jnp.zeros((4, head_ch)), seed=1)
    return cfg, {k: _part_tree(x) for k, x in v.items()}, full


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _config_leaves(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            yield from _config_leaves(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


def _block_yaml(leaves):
    """Nested block mappings with flow scalars and lists, the YAML subset
    the port's config files are written in."""
    lines, open_path = [], []
    for key, v in leaves:
        *parents, leaf = key.split(".")
        common = 0
        while common < min(len(parents), len(open_path)) \
                and parents[common] == open_path[common]:
            common += 1
        for depth in range(common, len(parents)):
            lines.append("  " * depth + parents[depth] + ":")
        open_path = parents
        value = list(v) if isinstance(v, tuple) else v
        text = yaml.safe_dump(value, default_flow_style=True)
        lines.append("  " * len(parents) + f"{leaf}: "
                     + text.removesuffix("...\n").strip())
    return "\n".join(lines) + "\n"


def _fields_equal(port, jax_cfg, path=""):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(got):
            _fields_equal(got, want, f"{path}{f.name}.")
        else:
            assert got == want and type(got) is type(want), (path + f.name, got, want)


@pytest.mark.parametrize("how", ["override", "yaml"])
def test_every_jax_config_key_loads(how, tmp_path):
    """Every leaf key of the JAX package's default_config loads into the
    port's config, one at a time as an override and all at once as a YAML
    file (the fields both configs have then agree); a key that neither
    config has still raises KeyError, in either form and under a JAX-only
    subtree."""
    leaves = list(_config_leaves(jax_default_config()))
    assert len(leaves) > 80
    if how == "override":
        for key, value in leaves:
            tconfig.apply_overrides(tconfig.default_config(), [(key, value)])
        for bad in ("model.fusion.no_such", "train.no_such", "no_such"):
            with pytest.raises(KeyError):
                tconfig.apply_overrides(tconfig.default_config(), [(bad, 1)])
        return
    path = tmp_path / "all_keys.yaml"
    path.write_text(_block_yaml(leaves))
    _fields_equal(tconfig.load_config(str(path)), jax_load_config(str(path)))
    for bad in ("model.fusion.no_such", "model.no_such.full", "train.no_such"):
        path.write_text(_block_yaml([(bad, 1)]))
        with pytest.raises(KeyError):
            tconfig.load_config(str(path))


# ---------------------------------------------------------------------------
# checkpoints in the three optimizer layouts, on a part of the model
# ---------------------------------------------------------------------------

# the optimizer layouts' part of the model: convolutions (grouped too),
# batch norms, a transposed convolution, dense layers and layer norms
PART = ("backbone2d.Conv_0", "backbone2d.BatchNorm_0", "backbone2d.MBStack_0",
        "neucon_net.sp_conv_2.up1", "neucon_net.sp_conv_2.up1_bn",
        "neucon_net.tsdf_pred_2")


def _part_tree(tree):
    out = {}
    for dotted in PART:
        *parents, leaf = dotted.split(".")
        src, dst = tree, out
        for p in parents:
            src, dst = src.get(p, {}), dst.setdefault(p, {})
        if leaf in src:
            dst[leaf] = src[leaf]
    return out


def _part_module(full):
    """Copies of the port modules of PART, under the same names."""
    part = torch.nn.Module()
    for dotted in PART:
        *parents, leaf = dotted.split(".")
        src, dst = full, part
        for p in parents:
            src = getattr(src, p)
            if not hasattr(dst, p):
                dst.add_module(p, torch.nn.Module())
            dst = getattr(dst, p)
        dst.add_module(leaf, copy.deepcopy(getattr(src, leaf)))
    return part


def _grads(params, rng):
    return jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), params)


def _configs(cfg, train):
    jcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))
    tcfg = tconfig.Config(model=port_model_config(cfg.model), train=dataclasses.replace(
        tconfig.default_config().train, **train))
    return jcfg, tcfg


def _micro_steps(tx, params, n, rng):
    """n steps of an optax transformation with seeded gradients; returns
    (params, state), the parameters updated as optax.apply_updates does."""
    opt_state = tx.init(params)
    for _ in range(n):
        updates, opt_state = tx.update(_grads(params, rng), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p) + np.asarray(u),
                                        params, updates)
    return params, opt_state


def _expected_state(full, params, stats):
    return variables_to_torch(_part_module(full), params, stats, {}).state_dict()


@pytest.fixture(scope="module")
def layout_ckpts(tiny, tmp_path_factory):
    """Per layout: three micro-steps of the JAX package's optimizer
    (make_optimizer, the layout's recipe) with seeded gradients, saved by
    its save_checkpoint at step 3 of epoch 1."""
    cfg, v, _ = tiny
    out = {}
    for layout, train in LAYOUTS.items():
        jcfg, tcfg = _configs(cfg, train)
        tx = make_optimizer(jcfg, 1000, freeze_mask_for(v["params"],
                                                        jcfg.train.finetune_layer))
        rng = np.random.default_rng(7)
        params, opt_state = _micro_steps(tx, v["params"], 3, rng)
        state = TrainState(params, {"batch_stats": v["batch_stats"], "buffers": {}},
                           opt_state, np.int32(3), np.int32(1))
        logdir = tmp_path_factory.mktemp(layout)
        path = jax_save(str(logdir), 1, state)
        assert tck.latest_checkpoint(str(logdir)) == path
        out[layout] = dict(path=path, tcfg=tcfg, tx=tx, params=params,
                           opt_state=opt_state, rng=rng)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_layouts(tiny, layout_ckpts, layout):
    """restore_checkpoint of each layout's checkpoint into the port's
    Trainer: the model equals convert.variables_to_torch of the same tree
    bit for bit, step, epoch and the optimizer's counts carry over, and
    the port's next Optimizer.step equals optax's next update within
    STEP_TOL of its scale (the parameters zeroed first, so the step's
    result is the update itself); frozen parameters take none."""
    _, v, full = tiny
    train = LAYOUTS[layout]
    c = layout_ckpts[layout]
    path, tx, params, opt_state, rng = (c[k] for k in ("path", "tx", "params",
                                                       "opt_state", "rng"))
    stats = v["batch_stats"]
    tcfg = c["tcfg"]

    trainer = tck.restore_checkpoint(path, Trainer(tcfg, _part_module(full),
                                                   device="cpu"))
    for name, want in _expected_state(full, params, stats).items():
        assert torch.equal(trainer.model.state_dict()[name], want), name
    opt = trainer.optimizer
    accumulating = train["accumulation_steps"] > 1
    assert (trainer.step_count, trainer.epoch) == (3, 1)
    assert (opt.updates, opt.mini_step) == ((1, 1) if accumulating else (3, 0))
    assert bool(opt.frozen) == (layout == "masked")
    assert all(float(x.abs().max()) > 0 for x in opt.nu.values())
    assert all(float(x.abs().max()) > 0 for x in opt.acc.values()) == accumulating

    grads = _grads(params, rng)
    updates, _ = tx.update(grads, opt_state, params)
    want = tree_to_torch(trainer.model, to_np(updates))
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.zero_()
    assert opt.step(tree_to_torch(trainer.model, grads))
    for name, p in trainer.model.named_parameters():
        if name in opt.frozen:
            assert not p.any() and not want[name].any(), name
            continue
        err = float((p.detach() - want[name]).abs().max())
        assert err <= STEP_TOL * float(want[name].abs().max()), (name, err)


def test_pre_flat_optimizer_refused_params_still_load(tiny, tmp_path):
    """A checkpoint from before the optimizer ran under optax.flatten
    (per-leaf Adam moments) is refused for a full resume, as the JAX
    package refuses it; its parameters still load (restore_model), and
    restore_submodule warm-starts exactly the tensors under a prefix."""
    cfg, v, full = tiny
    params, stats = v["params"], v["batch_stats"]
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0),
                                      optax.adam(1e-4)), 2)
    state = TrainState(params, {"batch_stats": stats, "buffers": {}},
                       tx.init(params), np.int32(0), np.int32(0))
    path = jax_save(str(tmp_path), 0, state)
    _, tcfg = _configs(cfg, dict(accumulation_steps=2))
    with pytest.raises(ValueError, match="pre-flat"):
        tck.restore_checkpoint(path, Trainer(tcfg, _part_module(full), device="cpu"))
    want = _expected_state(full, params, stats)
    model = tck.restore_model(path, _part_module(full))
    for name, x in model.state_dict().items():
        assert torch.equal(x, want[name]), name
    fresh = _part_module(full)
    before = {n: x.clone() for n, x in fresh.state_dict().items()}
    tck.restore_submodule(path, fresh, "neucon_net/sp_conv_2")
    for n, x in fresh.state_dict().items():
        inside = n.startswith("neucon_net.sp_conv_2.")
        assert torch.equal(x, want[n] if inside else before[n]), n


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tiny, tmp_path_factory):
    """A JAX training logdir holding model_000005: 9 micro-steps of the
    default recipe (accumulation 8: one update and one micro-step since),
    saved at step 9 of epoch 5; and the port's model state expected from
    it."""
    cfg, v, full = tiny
    tx = make_optimizer(cfg, 1000)
    params, opt_state = _micro_steps(tx, v["params"], 9, np.random.default_rng(3))
    logdir = tmp_path_factory.mktemp("jax_run")
    state = TrainState(params, {"batch_stats": v["batch_stats"], "buffers": {}},
                       opt_state, np.int32(9), np.int32(5))
    path = jax_save(str(logdir), 5, state)
    return logdir, path, params, opt_state, _expected_state(full, params,
                                                             v["batch_stats"])


@pytest.fixture
def part_model(tiny, monkeypatch):
    """The CLI builds PART in place of EPRecon."""
    from eprecon_tpu_torch.models import eprecon

    full = tiny[2]
    monkeypatch.setattr(eprecon, "EPRecon", lambda *a, **kw: _part_module(full))


def test_cli_test_mode_serves_a_jax_checkpoint(jax_run, part_model, monkeypatch,
                                               tmp_path):
    """python -m eprecon_tpu_torch.main --cfg config/test.yaml --device cpu
    ... loadckpt <orbax dir>: the reconstructor's model is the JAX tree's,
    bit for bit (the dataset is empty: the load is what is checked)."""
    path, want = jax_run[1], jax_run[-1]
    seen = {}
    monkeypatch.setattr(tmain, "build_dataset", lambda cfg, mode, **kw: [])
    monkeypatch.setattr(tloop, "evaluate",
                        lambda cfg, recon, samples, **kw: seen.update(recon=recon) or [])
    tmain.main(["--cfg", str(REPO / "config/test.yaml"), "--device", "cpu", *TINY,
                "logdir", str(tmp_path), "loadckpt", path])
    got = seen["recon"].model.state_dict()
    assert set(got) == set(want)
    for name, x in got.items():
        assert torch.equal(x, want[name]), name


def _jax_order_tree(flat, params):
    """A raveled vector as a params-shaped tree, in JAX's own flattening
    order (jax.tree_util), as ravel_pytree lays it out."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    chunks, offset = [], 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        chunks.append(np.asarray(flat)[offset:offset + n].reshape(leaf.shape))
        offset += n
    assert offset == np.asarray(flat).size
    return jax.tree_util.tree_unflatten(treedef, chunks)


def test_resume_over_a_jax_logdir_and_the_importer_tool(jax_run, part_model,
                                                        monkeypatch, tmp_path):
    """run_train with resume over the JAX logdir restores model_000005 into
    the Trainer: the model bit for bit, step 9, epoch 5, update 1 at
    micro-step 1, and Adam's moments and the accumulated gradients as the
    flat vectors laid out in JAX's own leaf order. The importer's CLI
    writes the same state to the port's checkpoint file."""
    logdir, path, params, opt_state, want = jax_run
    monkeypatch.setattr(tmain, "build_dataset", lambda cfg, mode, **kw: [None] * 4)
    monkeypatch.setattr(tloop, "train_epochs", lambda cfg, trainer, it: trainer)
    opts = TINY + ["logdir", str(logdir), "resume", "true", "train.n_workers", "0"]
    cfg = tconfig.load_config(str(REPO / "config/train.yaml"),
                              tconfig.parse_cli_overrides(opts))
    trainer = tmain.run_train(cfg, "cpu")
    for name, x in trainer.model.state_dict().items():
        assert torch.equal(x, want[name]), name
    opt = trainer.optimizer
    assert (trainer.step_count, trainer.epoch, opt.updates, opt.mini_step) == (9, 5, 1, 1)
    adam = opt_state.inner_opt_state[1][0]
    for key, flat in (("mu", adam.mu), ("nu", adam.nu), ("acc", opt_state.acc_grads)):
        named = tree_to_torch(trainer.model, _jax_order_tree(flat, params))
        mine = getattr(opt, key)
        assert set(mine) == set(named)
        for name, x in mine.items():
            assert torch.equal(x, named[name]), (key, name)

    out = tmp_path / "model_000005"
    ij.main([path, str(out), "--cfg", str(REPO / "config/train.yaml"), *TINY])
    written = torch.load(out, weights_only=True)
    mine = trainer.state_dict()
    assert (written["step"], written["epoch"]) == (9, 5)
    for name, x in mine["model"].items():
        assert torch.equal(written["model"][name], x), name
    for key in ("mu", "nu", "acc"):
        for name, x in mine["optimizer"][key].items():
            assert torch.equal(written["optimizer"][key][name], x), (key, name)


def _same_tree(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_reading_needs_no_jax(jax_run, layout_ckpts, tmp_path):
    """read_orbax_tree, in a process where jax, flax, optax, orbax and
    eprecon_tpu cannot be imported, reads each optimizer layout's
    checkpoint and the CLI's as they are read here: the same tree, every
    array bit for bit."""
    paths = [jax_run[1]] + [c["path"] for c in layout_ckpts.values()]
    blocked = ("jax", "jaxlib", "flax", "optax", "orbax", "eprecon_tpu")
    code = (
        "import pickle, sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "from eprecon_tpu_torch.tools.import_jax_checkpoint import read_orbax_tree\n"
        f"trees = [read_orbax_tree(p) for p in {paths!r}]\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "with open(sys.argv[1], 'wb') as f:\n"
        "    pickle.dump(trees, f)\n")
    out = tmp_path / "trees.pkl"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", code, str(out)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        trees = pickle.load(f)
    for path, tree in zip(paths, trees, strict=True):
        _same_tree(tree, ij.read_orbax_tree(path), path)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _seeded_session(m, rng):
    """A JAX RecurrentState and PanopticGlobalDense of the config's shapes
    from a seed (no forward)."""
    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return jnp.asarray(rng.random(x.shape) < 0.3)
        if x.dtype == np.int32:
            return jnp.asarray(rng.integers(0, 50, x.shape, dtype=np.int32))
        return jnp.asarray(rng.standard_normal(x.shape), x.dtype)

    rec = jax.tree_util.tree_map(fill, jax_state(m))
    pmap = jax.tree_util.tree_map(fill, JaxPanoptic.empty(tuple(m.global_extent)))
    return rec, pmap


def test_jax_session_restores_exactly(tmp_path):
    """A session written by the JAX package's save_session (state from a
    seed) restores in the port: every state tensor equals the JAX leaf it
    stands for, reshaped ([Gx, Gy, Gz*C] feature maps to [Gx, Gy, Gz, C]),
    exactly and in the same dtype; scene, origin, overflow counters and
    clipped count carry over. chip_smoke.write_jax_session, which writes
    this layout on the card, writes the same file from the port's state."""
    cfg = g._tiny_cfg()
    # a smaller global volume: save_session compresses the maps
    m = dataclasses.replace(cfg.model, global_extent=(32, 32, 16))
    cfg = dataclasses.replace(cfg, model=m)
    jrec, jpmap = _seeded_session(m, np.random.default_rng(11))
    js = JaxStreaming(cfg, None)
    js.rec_state, js.pmap_state = jrec, jpmap
    js.scene_name, js.global_origin = "scene0007_00", np.asarray([0.5, -1.0, 0.25],
                                                                  np.float32)
    js._overflows, js.clipped_fragments = [jnp.asarray(3), jnp.asarray(0)], 1
    js.save_session(str(tmp_path / "jax.npz"))

    port = StreamingReconstructor(tconfig.Config(model=port_model_config(m)),
                                  torch.nn.Linear(1, 1), device="cpu")
    port.restore_session(str(tmp_path / "jax.npz"))
    want = {}
    for i, (gm, tm) in enumerate(zip(jrec.gmaps, jrec.tmaps)):
        want.update({f"gmap{i}_feats": gm.feats, f"gmap{i}_mask": gm.mask,
                     f"tmap{i}_tsdf": tm.tsdf, f"tmap{i}_occ": tm.occ})
    want.update({f"pmap_{k}": x for k, x in jpmap._asdict().items()})
    got = port._state_arrays()
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        x = got[name]
        assert str(x.dtype).removeprefix("torch.") == w.dtype.name, name
        np.testing.assert_array_equal(
            (x.float() if x.dtype == torch.bfloat16 else x).numpy(),
            w.astype(np.float32).reshape(x.shape) if w.dtype.name == "bfloat16"
            else w.reshape(x.shape), err_msg=name)
    assert port.scene_name == "scene0007_00" and port.clipped_fragments == 1
    np.testing.assert_array_equal(port.global_origin, js.global_origin)
    assert [int(o) for o in port._overflows] == [3, 0]

    write_jax_session(port, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _seeded_like(shapes, seed):
    """optax's state structure (jax.eval_shape of tx.init) with leaves from
    a seed: counts 1, mini_step 1, moments and accumulated gradients
    normal, second moments positive."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "name", getattr(path[-1], "key", "")))
        if name in ("count", "gradient_step", "mini_step"):
            return np.asarray(1, leaf.dtype)
        x = rng.standard_normal(leaf.shape)
        return (np.abs(x) if name == "nu" else x).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def time_full_width_import(workdir: str):
    """Host seconds of the importer on a full-width JAX checkpoint: the
    tiny config's EPRecon has the default config's 1338 tensors (the
    widths; only the volumes are smaller), its random variables with the
    default recipe's optimizer state filled from a seed, saved by the JAX
    package; then the importer's CLI (which prints its read, convert and
    write seconds) and restore_model, on this host's CPU."""
    import time

    cfg = g._tiny_cfg()
    m = cfg.model
    probe = FragmentInputs(jnp.zeros((2, m.n_layer, 4, 4)), jnp.zeros(3),
                           jnp.eye(4), jnp.zeros((m.n_layer, 3), jnp.int32))
    v = random_variables(EPRecon(m), jnp.zeros((2, 32, 48, 3)), probe,
                         jax_state(m), None, seed=1)
    tx = make_optimizer(cfg, 1000)
    state = TrainState(v["params"], {"batch_stats": v["batch_stats"],
                                     "buffers": v["buffers"]},
                       _seeded_like(jax.eval_shape(tx.init, v["params"]), 3),
                       np.int32(8), np.int32(1))
    path = jax_save(workdir, 1, state)
    n = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v["params"]))
    print(f"JAX checkpoint {path}: {n} parameters")
    out = os.path.join(workdir, "imported.pt")
    overrides = [*TINY, "model.n_vox", "[96,96,96]", "model.voxel_size", "0.04",
                 "model.voxel_capacity", "[16384,65536,131072]",
                 "model.global_extent", "[256,256,128]"]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "eprecon_tpu_torch.tools.import_jax_checkpoint",
         path, out, "--cfg", str(REPO / "config/train.yaml"), *overrides],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, check=True)
    print(run.stdout.strip())
    print(f"importer CLI wall (process included): "
          f"{time.perf_counter() - t0:.3f} s (host)")
    model = te.EPRecon(tconfig.default_config().model)
    t0 = time.perf_counter()
    tck.restore_model(path, model)
    print(f"restore_model of the orbax directory: "
          f"{time.perf_counter() - t0:.3f} s (host)")


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        time_full_width_import(d)
