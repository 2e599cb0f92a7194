"""The port's SPVCNN research engine (`eprecon_tpu_torch/models/spvcnn.py`)
against eprecon_tpu/models/spvcnn.py on seeded numpy point clouds, flax
weights carried by `convert`, the cases of tests/test_spvcnn.py.

The plans' coordinate sets and index links are exact (keyed by
coordinate: the table's representative row is the engine's choice, see
tests/test_torch_sparse_engine.py); per-point outputs within 1e-4 of their
scale (f32 sums of 27-offset gathers through eight convs), updated batch
statistics within 1e-5. Dropout is off in the comparisons: the JAX module
draws from its 'dropout' RNG stream and the port from a torch.Generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel, load, one_torch_thread, t, to_np
from torch_parity import random_variables

from eprecon_tpu.models import spvcnn as jspv
from eprecon_tpu.ops import sparse as jsp
from eprecon_tpu_torch.models import spvcnn as tspv
from eprecon_tpu_torch.ops import sparse as tsp

OUT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def point_sets(n, cap, c, span=3.0, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, span, (n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, c)).astype(np.float32)
    pad = cap - n
    arrays = (np.concatenate([xyz, np.zeros((pad, 3), np.float32)]),
              np.zeros(cap, np.int32),
              np.concatenate([feats, np.zeros((pad, c), np.float32)]),
              np.arange(cap) < n)
    return (jsp.PointSet(*map(jnp.asarray, arrays)),
            tsp.PointSet(*map(t, arrays)))


@pytest.fixture(scope="module")
def cloud():
    """300 points in 512 slots, 8 channels, and both packages' plans at
    20 cm."""
    jp, tp = point_sets(300, 512, 8)
    jplan = jax.jit(lambda p: jspv.build_plan(p, vres=0.2))(jp)
    with one_torch_thread():
        tplan = tspv.build_plan(tp, vres=0.2)
    return jp, tp, jplan, tplan


def coords_of(grid, rows):
    """Coordinates of `rows` (-1: None) in `grid`."""
    c = np.asarray(grid.voxels.coords)
    return [tuple(c[r]) if r >= 0 else None for r in np.asarray(rows).ravel()]


def test_build_plan_matches_jax(cloud):
    """Every level's voxel set, same-level neighbours, stride-2 inputs,
    parents and offsets, keyed by coordinate; the devoxelisation links per
    point."""
    jp, _, jplan, tplan = cloud
    expect = len({tuple(v) for v in np.floor(np.asarray(jp.xyz)[:300] / 0.2)
                  .astype(int)})
    assert int(tplan.levels[0].grid.voxels.num_valid()) == expect
    for lv, (jl, tl) in enumerate(zip(jplan.levels, tplan.levels)):
        jv, tv = jl.grid.voxels, tl.grid.voxels
        jrows = np.flatnonzero(np.asarray(jv.valid))
        trows = np.flatnonzero(tv.valid.numpy())
        jkey = {tuple(np.asarray(jv.coords)[r]): r for r in jrows}
        tkey = {tuple(tv.coords.numpy()[r]): r for r in trows}
        assert jkey.keys() == tkey.keys(), f"level {lv}"
        for key, tr in tkey.items():
            jr = jkey[key]
            assert (coords_of(tl.grid, tl.nmap27.numpy()[tr])
                    == coords_of(jl.grid, np.asarray(jl.nmap27)[jr]))
            if lv > 0:
                fine_t, fine_j = tplan.levels[lv - 1].grid, jplan.levels[lv - 1].grid
                assert (coords_of(fine_t, tl.down_nmap8.numpy()[tr])
                        == coords_of(fine_j, np.asarray(jl.down_nmap8)[jr]))
        if lv > 0:
            fine_t, fine_j = tplan.levels[lv - 1].grid, jplan.levels[lv - 1].grid
            fj = {tuple(np.asarray(fine_j.voxels.coords)[r]): r
                  for r in np.flatnonzero(np.asarray(fine_j.voxels.valid))}
            for r in np.flatnonzero(fine_t.voxels.valid.numpy()):
                key = tuple(fine_t.voxels.coords.numpy()[r])
                assert (coords_of(tl.grid, tl.parent_of_fine.numpy()[r:r + 1])
                        == coords_of(jl.grid, np.asarray(jl.parent_of_fine)[fj[key]:fj[key] + 1]))
                assert tl.fine_mod2.numpy()[r] == np.asarray(jl.fine_mod2)[fj[key]]
        assert (coords_of(tl.grid, tplan.devox_idx[lv].numpy())
                == coords_of(jl.grid, np.asarray(jplan.devox_idx[lv])))
        np.testing.assert_allclose(tplan.devox_w[lv].numpy(),
                                   np.asarray(jplan.devox_w[lv]), atol=1e-6)
    assert (coords_of(tplan.levels[0].grid, tplan.point_to_l0.numpy())
            == coords_of(jplan.levels[0].grid, np.asarray(jplan.point_to_l0)))


def batch_stats_of(module):
    return {n: b.detach().numpy().copy() for n, b in module.named_buffers()}


def flax_stats_by_port_name(tree, module):
    """The flax batch_stats tree in the port's buffer names."""
    from eprecon_tpu_torch.convert import tree_to_torch

    return {n: v.numpy() for n, v in tree_to_torch(module, to_np(tree)).items()}


@pytest.mark.parametrize("cr", [0.25, 0.5])
@pytest.mark.parametrize("running", [False, True])
def test_spvcnn_matches_jax(cloud, cr, running):
    """Per-point output within 1e-4 of its scale, in train-mode BN (and its
    updated running statistics within 1e-5) and with running averages."""
    jp, tp, jplan, tplan = cloud
    jm = jspv.SPVCNN(cr=cr, use_running_average=running)
    variables = random_variables(jm, jp.feats, jplan, seed=3)
    tm = load(tspv.SPVCNN(8, cr=cr, use_running_average=running,
                                  device="cpu"), variables)
    out, upd = jax.jit(lambda v, x, p: jm.apply(v, x, p,
                                                mutable=["batch_stats"]))(
        variables, jp.feats, jplan)
    got = tm(tp.feats, tplan)
    assert got.shape == (512, int(96 * cr))
    assert_rel(got, out, OUT_TOL, "spvcnn")
    assert (got[300:] == 0).all()
    if not running:
        want = flax_stats_by_port_name(upd["batch_stats"], tm)
        have = batch_stats_of(tm)
        assert want.keys() == have.keys()
        for name in want:
            np.testing.assert_allclose(have[name], want[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_spvcnn_padding_invariance():
    """Garbage in the padding slots changes no valid output."""
    _, tp = point_sets(100, 128, 8, seed=1)
    plan = tspv.build_plan(tp, vres=0.25)
    m = tspv.SPVCNN(8, cr=0.25, seed=0, device="cpu")
    out1 = m(tp.feats, plan)
    out2 = m(tp.feats.index_fill(0, torch.arange(100, 128), 1e3), plan)
    np.testing.assert_allclose(out1[:100].detach().numpy(),
                               out2[:100].detach().numpy(), rtol=1e-5, atol=1e-5)


def test_spvcnn_dropout_takes_a_generator():
    """dropout=True draws from the caller's generator: the same seed gives
    the same output, a training forward without one is refused, and an
    inference forward runs no dropout."""
    _, tp = point_sets(100, 128, 8, seed=2)
    plan = tspv.build_plan(tp, vres=0.25)
    m = tspv.SPVCNN(8, cr=0.25, dropout=True, use_running_average=True,
                    device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        m(tp.feats, plan)
    a = m(tp.feats, plan, generator=torch.Generator().manual_seed(5))
    b = m(tp.feats, plan, generator=torch.Generator().manual_seed(5))
    c = m(tp.feats, plan, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    plain = tspv.SPVCNN(8, cr=0.25, use_running_average=True, device="cpu")
    plain.load_state_dict(m.state_dict())
    torch.testing.assert_close(m(tp.feats, plan, train=False),
                               plain(tp.feats, plan), rtol=0, atol=0)


def test_sconv3d_and_convgru_match_jax():
    jp, tp = point_sets(150, 256, 6, seed=4)
    jplan = jax.jit(lambda p: jspv.build_sconv_plan(p, vres=0.2))(jp)
    tplan = tspv.build_sconv_plan(tp, vres=0.2)
    assert (coords_of(tplan.grid, tplan.idx_query.numpy())
            == coords_of(jplan.grid, np.asarray(jplan.idx_query)))
    h = np.random.default_rng(5).standard_normal((256, 6)).astype(np.float32)

    jconv = jspv.SConv3d(5)
    v = random_variables(jconv, jp.feats, jplan, seed=6)
    tconv = load(tspv.SConv3d(6, 5, device="cpu"), v)
    assert_rel(tconv(tp.feats, tplan),
               jax.jit(jconv.apply)(v, jp.feats, jplan), OUT_TOL, "sconv3d")

    jgru = jspv.ConvGRU(hidden_dim=6)
    v = random_variables(jgru, jnp.asarray(h), jp.feats, jplan, seed=7)
    tgru = load(tspv.ConvGRU(6, 6, device="cpu"), v)
    want = jax.jit(jgru.apply)(v, jnp.asarray(h), jp.feats, jplan)
    got = tgru(t(h), tp.feats, tplan)
    assert got.shape == (256, 6)
    assert_rel(got, want, OUT_TOL, "convgru")


def test_engine_defaults_to_cuda(monkeypatch):
    """The engine's modules are entry points: made on CUDA unless the caller
    asks for the CPU, and refused where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tspv.SPVCNN(8, cr=0.25), lambda: tspv.SConv3d(4, 4),
                 lambda: tspv.ConvGRU(4, 4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert tspv.ConvGRU(4, 4, device="cpu").convz.weight.device.type == "cpu"
