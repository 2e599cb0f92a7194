"""Whole-forward parity: EPReconCore over two fragments with the recurrent
state threaded, and StreamingReconstructor over a scene change, JAX
against the port, on the tiny config's shapes (__graft_entry__._tiny_cfg:
32^3 window at 12 cm) with a 2-layer, 16-wide decoder.

Stage masks are made threshold-free (stage thresholds -100, occupancy-init
threshold 0), so every boolean selection is a function of the view counts
alone; with the geometry the counts agree exactly, which teacher-forces
the active sets of both sides without touching either forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from torch_parity import (assert_rel, load, one_torch_thread, port_model_config,
                          random_variables)

from eprecon_tpu.data.synthetic import make_fragment, make_scene
from eprecon_tpu.inference.pipeline import StreamingReconstructor as JaxStreaming
from eprecon_tpu.models.eprecon import (EPRecon, EPReconCore, FragmentInputs,
                                        FragmentTargets)
from eprecon_tpu.models.eprecon import make_recurrent_state as jax_state
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.ops import grid
from eprecon_tpu_torch.train.loop import fragment_targets

VIEWS, HW = 3, (48, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    cfg = g._tiny_cfg()
    pan = dataclasses.replace(cfg.model.panoptic, num_queries=16, dec_layers=2,
                              hidden_dim=16, nheads=4)
    m = dataclasses.replace(cfg.model, thresholds=(-100.0,) * 3,
                            occ_init_threshold=0.0,
                            voxel_capacity=(512, 4096, 32768), panoptic=pan)
    scene = make_scene(0)
    frags = [make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                           voxel_size=m.voxel_size, scene=scene, start_angle=a)
             for a in (0.0, 0.4)]
    frags.append(make_fragment(n_views=VIEWS, image_hw=HW, n_vox=m.n_vox,
                               voxel_size=m.voxel_size, seed=5))
    return dataclasses.replace(cfg, model=m), m, frags


def _targets(d):
    """The fragment's GT as the data pipeline's sample keys hold it."""
    return dict(tsdf_list=d["tsdf_levels"], occ_list=d["occ_levels"],
                semantic=d["semantic"], instance=d["instance"])


def _jax_targets(d):
    return FragmentTargets(tuple(jnp.asarray(x) for x in d["tsdf_levels"]),
                           tuple(jnp.asarray(x) for x in d["occ_levels"]),
                           jnp.asarray(d["semantic"]), jnp.asarray(d["instance"]))


def _rel_origins(m, frag, global_origin):
    return np.stack([np.round((frag["vol_origin_partial"] - global_origin)
                              / (m.voxel_size * 2 ** (m.n_scales - i)))
                     for i in range(m.n_layer)]).astype(np.int32)


def _compare_outputs(got, want):
    for k, w in want.items():
        if k not in got or not hasattr(w, "shape"):
            continue
        w = np.asarray(w)
        gk = got[k]
        if w.dtype == bool or w.dtype.kind in "iu":
            np.testing.assert_array_equal(gk.numpy(), w, err_msg=k)
        elif k == "occ_init_logits":
            # bf16 (JAX) vs f32 (port) variance sums, see test_torch_modules
            assert_rel(gk, w.astype(np.float32), 0.2, k)
        else:
            assert_rel(gk, w.astype(np.float32), 3e-2, k)


def test_core_two_fragments(setup):
    """EPReconCore with running-statistics BN (no reduction-order chaos):
    back-projection, U-Nets, GRU fusion, heads and decoder per stage, over
    two fragments whose windows overlap in the global maps. bf16 network:
    3e-2 of each tensor's scale; masks, counts and coordinates exact."""
    _, m, frags = setup
    rng = np.random.default_rng(0)
    origin0 = grid.scene_global_origin(m.global_extent, m.n_vox, m.n_scales,
                                       m.voxel_size,
                                       frags[0]["vol_origin_partial"] - 0.3,
                                       m.origin_margin)
    core = EPReconCore(m, use_running_average=True, debug_outputs=True)
    tcore = te.EPReconCore(port_model_config(m), use_running_average=True)
    jstate, tstate = jax_state(m), te.make_recurrent_state(tcore.cfg)
    apply = jax.jit(lambda v, a, b, f, s: core.apply(v, a, b, f, s, None))
    variables = None
    for d in frags[:2]:
        feats = [[(0.5 * rng.standard_normal((VIEWS, HW[0] // s, HW[1] // s, c))
                   ).astype(np.float32) for s, c in ((4, 24), (8, 40), (16, 80))]
                 for _ in range(2)]
        rel = _rel_origins(m, d, origin0)
        jfrag = FragmentInputs(jnp.asarray(d["proj_matrices"]),
                               jnp.asarray(d["vol_origin_partial"]),
                               jnp.asarray(d["world_to_aligned_camera"]),
                               jnp.asarray(rel))
        tfrag = te.FragmentInputs(torch.from_numpy(d["proj_matrices"]),
                                  torch.from_numpy(d["vol_origin_partial"]),
                                  torch.from_numpy(d["world_to_aligned_camera"]),
                                  rel)
        jf = [[jnp.asarray(x) for x in fs] for fs in feats]
        if variables is None:
            variables = random_variables(core, *jf, jfrag, jstate, None)
            load(tcore, variables)
        want, _, jstate = apply(variables, *jf, jfrag, jstate)
        with torch.no_grad():
            got, _, tstate = tcore(*[[torch.from_numpy(x) for x in fs] for fs in feats],
                                tfrag, tstate, debug_outputs=True)
        assert int(got["n_occ_2"]) > 1000
        _compare_outputs(got, want)
        for jg, tg in zip(jstate.gmaps, tstate.gmaps):
            np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
            assert_rel(tg.feats, np.asarray(jg.feats, np.float32).reshape(
                tg.feats.shape), 3e-2, "global map")


def _streaming_variables(m, frags):
    imgs = jnp.asarray(frags[0]["imgs"])
    probe = FragmentInputs(jnp.asarray(frags[0]["proj_matrices"]),
                           jnp.asarray(frags[0]["vol_origin_partial"]),
                           jnp.asarray(frags[0]["world_to_aligned_camera"]),
                           jnp.zeros((3, 3), jnp.int32))
    return random_variables(EPRecon(m), imgs, probe, jax_state(m), None, seed=1)


LOSS_FLOOR = 1e-3   # relative changes are taken against max(|loss|, this)
# Port vs JAX, per loss term, relative: twice the largest change of JAX's own
# loss under half a grey level of image noise (`jax_noise_loss_spread`, three
# draws: occupancy init 0.048/0.105/0.165, tsdf_occ 0 0.034/0.030/0.060,
# 1 0.043/0.015/0.031, 2 0.003/0.013/0.010, panoptic 0.019/0.031/0.020,
# total 0.011/0.038/0.035); three draws understate the spread's tail. The
# port measured 0.038, 0.060, 0.021, 0.0074, 0.045, 0.021.
LOSS_TOL = {"occupancy_initialization_loss": 0.33, "tsdf_occ_loss_0": 0.12,
            "tsdf_occ_loss_1": 0.086, "tsdf_occ_loss_2": 0.027,
            "panoptic_loss": 0.063, "total_loss": 0.077}


@pytest.mark.filterwarnings("ignore:scene '.' exceeds the global volume")
def test_streaming_reconstructor(setup):
    """The serving path as a user calls it, batch-statistics BN included:
    two fragments of scene 'a', then scene 'b' flushes 'a'.

    With batch statistics, random weights and bf16, the JAX model is
    itself chaotic: half a grey level of image noise moves its own global
    maps to correlation 0.91-0.94 (measured on this config). So the maps
    are held by correlation > 0.9, while what is a function of geometry
    (map masks, scene origin) must agree exactly. Instance ids come from
    thresholds on those noisy values and are checked for range only.
    With the fragments' GT as targets, the losses of each fragment
    (`last_losses`) are held to JAX's within LOSS_TOL."""
    cfg, m, frags = setup
    variables = _streaming_variables(m, frags)
    jrec = JaxStreaming(cfg, variables)
    model = load(te.EPRecon(port_model_config(m)), variables)
    trec = StreamingReconstructor(tconfig.Config(model=port_model_config(m)),
                                  model, device="cpu")
    finished = []
    for name, d in zip("aab", frags):
        args = (name, d["imgs"], d["proj_matrices"], d["vol_origin_partial"] - 0.5,
                d["vol_origin_partial"], d["world_to_aligned_camera"])
        want = jrec.process_fragment(*args, targets=_jax_targets(d))
        got = trec.process_fragment(
            *args, targets=fragment_targets(_targets(d), trec.device))
        finished.append((got, want))
        assert trec.last_losses.keys() == jrec.last_losses.keys()
        for k, w in jrec.last_losses.items():
            w, v = float(w), float(trec.last_losses[k])
            assert np.isfinite(v) and w > 0
            assert abs(v - w) / max(abs(w), LOSS_FLOOR) <= LOSS_TOL[k], (name, k, v, w)
        for jg, tg in zip(jrec.rec_state.gmaps, trec.rec_state.gmaps):
            jm = np.asarray(jg.mask)
            np.testing.assert_array_equal(tg.mask.numpy(), jm)
            a = np.asarray(jg.feats, np.float32).reshape(tg.feats.shape)[jm]
            b = tg.feats.float().numpy()[jm]
            assert np.isfinite(b).all() and jm.sum() > 50
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9
        np.testing.assert_array_equal(trec.pmap_state.next_instance_id.numpy(),
                                      np.asarray(jrec.pmap_state.next_instance_id))
    assert finished[0] == (None, None) and finished[1] == (None, None)
    got, want = finished[2]
    assert got.name == want.name == "a"
    np.testing.assert_allclose(got.origin, want.origin)
    assert np.isfinite(got.tsdf).all() and (np.abs(got.tsdf) < 1).any()
    assert got.overflow == want.overflow and got.clipped == want.clipped
    assert got.instance.shape == want.instance.shape
    assert 0 <= got.instance.min() and got.instance.max() < 1024


def jax_noise_loss_spread(draws: int = 3, seed: int = 123):
    """Per draw of half a grey level of uniform image noise on every
    fragment: the largest relative change of each of JAX's streaming
    losses (over the three fragments of test_streaming_reconstructor)
    against JAX's without the noise. LOSS_TOL comes from these. Run from
    the repository's root:

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_forward.py
    """
    cfg, m, frags = _setup()
    variables = _streaming_variables(m, frags)
    jrec = JaxStreaming(cfg, variables)

    def losses(noise):
        jrec.scene_name = None
        out = []
        for name, d, n in zip("aab", frags, noise):
            imgs = np.clip(d["imgs"] + n, 0, 255).astype(np.float32)
            jrec.process_fragment(name, imgs, d["proj_matrices"],
                                  d["vol_origin_partial"] - 0.5,
                                  d["vol_origin_partial"],
                                  d["world_to_aligned_camera"],
                                  targets=_jax_targets(d))
            out.append({k: float(v) for k, v in jrec.last_losses.items()})
        return out

    base = losses([0.0] * len(frags))
    rng = np.random.default_rng(seed)
    spread = []
    for _ in range(draws):
        noisy = losses([rng.uniform(-0.5, 0.5, d["imgs"].shape) for d in frags])
        spread.append({k: max(abs(n[k] - b[k]) / max(abs(b[k]), LOSS_FLOOR)
                              for n, b in zip(noisy, base)) for k in base[0]})
    return base, spread


if __name__ == "__main__":
    import os

    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0 "
                          "--xla_llvm_disable_expensive_passes=true")
    jax.config.update("jax_platforms", "cpu")
    base, spread = jax_noise_loss_spread()
    print("losses without noise:", base)
    for i, sp in enumerate(spread):
        print(f"draw {i}: largest relative change per term "
              f"{ {k: round(v, 4) for k, v in sp.items()} }")


def test_session_round_trip(setup, tmp_path):
    """save_session after the first fragment, restore_session into a fresh
    reconstructor, then the rest of the stream (targets included): the
    maps, the losses and both flushed scenes equal the uninterrupted
    stream's bit for bit."""
    cfg, m, frags = setup
    tcfg = tconfig.Config(model=port_model_config(m))
    model = te.EPRecon(tcfg.model, seed=3)
    whole = StreamingReconstructor(tcfg, model, device="cpu")
    first = StreamingReconstructor(tcfg, model, device="cpu")
    resumed = StreamingReconstructor(tcfg, model, device="cpu")

    def feed(rec, name, d):
        return rec.process_fragment(
            name, d["imgs"], d["proj_matrices"], d["vol_origin_partial"] - 0.5,
            d["vol_origin_partial"], d["world_to_aligned_camera"],
            targets=fragment_targets(_targets(d), rec.device))

    feed(whole, "a", frags[0])
    feed(first, "a", frags[0])
    first.save_session(str(tmp_path / "session.npz"))
    resumed.restore_session(str(tmp_path / "session.npz"))
    for rec in (whole, resumed):
        feed(rec, "a", frags[1])
    for a, b in zip(whole._state_arrays().values(),
                    resumed._state_arrays().values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in whole.last_losses.items():
        assert torch.equal(v, resumed.last_losses[k]), k
    ends = [(feed(rec, "b", frags[2]), rec.flush()) for rec in (whole, resumed)]
    for a, b in zip(*ends):
        assert a.name == b.name and a.overflow == b.overflow
        for f in ("origin", "tsdf", "instance", "semantic"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert ends[0][0].name == "a" and ends[0][1].name == "b"
