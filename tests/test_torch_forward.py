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
from torch_parity import assert_rel, load, port_model_config, random_variables

from eprecon_tpu.data.synthetic import make_fragment, make_scene
from eprecon_tpu.inference.pipeline import StreamingReconstructor as JaxStreaming
from eprecon_tpu.models.eprecon import EPRecon, EPReconCore, FragmentInputs
from eprecon_tpu.models.eprecon import make_recurrent_state as jax_state
from eprecon_tpu_torch import config as tconfig
from eprecon_tpu_torch.inference.pipeline import StreamingReconstructor
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.ops import grid

VIEWS, HW = 3, (48, 64)


@pytest.fixture(scope="module")
def setup():
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


@pytest.mark.filterwarnings("ignore:scene '.' exceeds the global volume")
def test_streaming_reconstructor(setup):
    """The serving path as a user calls it, batch-statistics BN included:
    two fragments of scene 'a', then scene 'b' flushes 'a'.

    With batch statistics, random weights and bf16, the JAX model is
    itself chaotic: half a grey level of image noise moves its own global
    maps to correlation 0.91-0.94 (measured on this config). So the maps
    are held by correlation > 0.9, while what is a function of geometry
    (map masks, scene origin) must agree exactly. Instance ids come from
    thresholds on those noisy values and are checked for range only."""
    cfg, m, frags = setup
    imgs = jnp.asarray(frags[0]["imgs"])
    probe = FragmentInputs(jnp.asarray(frags[0]["proj_matrices"]),
                           jnp.asarray(frags[0]["vol_origin_partial"]),
                           jnp.asarray(frags[0]["world_to_aligned_camera"]),
                           jnp.zeros((3, 3), jnp.int32))
    variables = random_variables(EPRecon(m), imgs, probe, jax_state(m), None,
                                 seed=1)
    jrec = JaxStreaming(cfg, variables)
    model = load(te.EPRecon(port_model_config(m)), variables)
    trec = StreamingReconstructor(tconfig.Config(model=port_model_config(m)),
                                  model, device="cpu")
    finished = []
    for name, d in zip("aab", frags):
        args = (name, d["imgs"], d["proj_matrices"], d["vol_origin_partial"] - 0.5,
                d["vol_origin_partial"], d["world_to_aligned_camera"])
        want = jrec.process_fragment(*args)
        got = trec.process_fragment(*args)
        finished.append((got, want))
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
