"""The parts of the training step, JAX against the port on seeded numpy
inputs: losses, panoptic targets and set criterion, the auction matcher
(also against scipy's optimum), GT target-volume fusion, the synthetic
fragments' GT, BatchNorm running statistics, and the global-map writeback
that must not carry the graph from one fragment to the next.

Tolerances: f32 losses 1e-5 (summation order); integer and boolean results
exact; running statistics 1e-6.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from torch_parity import load, random_variables, rounding_keep_masks, t

from eprecon_tpu.models import dense3d as jd
from eprecon_tpu.models import gru_fusion as jg
from eprecon_tpu.models.panoptic import criterion as jcrit
from eprecon_tpu.models.panoptic import matcher as jmatch
from eprecon_tpu.train import losses as jloss
from eprecon_tpu_torch.models import dense3d as td
from eprecon_tpu_torch.models import gru_fusion as tg
from eprecon_tpu_torch.models.layers import BatchNorm, init_module
from eprecon_tpu_torch.models.panoptic import criterion as tcrit
from eprecon_tpu_torch.models.panoptic import matcher as tmatch
from eprecon_tpu_torch.train import losses as tloss


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positives", [True, False])
def test_losses_match_jax(positives):
    """Occupancy-init and tsdf/occ losses; without positives both are the
    graph-keeping zero."""
    rng = np.random.default_rng(0)
    n = 4000
    logits = (2 * rng.standard_normal(n)).astype(np.float32)
    tsdf_pred = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    tsdf_t = np.clip(rng.uniform(-1.5, 1.5, n), -1, 1).astype(np.float32)
    occ_t = (np.abs(tsdf_t) < 0.7) & positives
    mask = rng.uniform(size=n) < 0.7
    t_init = np.clip(1 - np.abs(tsdf_t), 0, 1) * positives
    want = jloss.occupancy_init_loss(jnp.asarray(logits), jnp.asarray(t_init),
                                     jnp.asarray(occ_t), jnp.asarray(mask))
    got = tloss.occupancy_init_loss(t(logits), t(t_init), t(occ_t), t(mask))
    _close(got, want)
    want = jloss.tsdf_occ_loss(jnp.asarray(tsdf_pred), jnp.asarray(logits),
                               jnp.asarray(tsdf_t), jnp.asarray(occ_t),
                               jnp.asarray(mask), 1.5)
    got = tloss.tsdf_occ_loss(t(tsdf_pred), t(logits), t(tsdf_t), t(occ_t),
                              t(mask), 1.5)
    _close(got, want)
    assert (float(got) > 0) == positives


# ---------------------------------------------------------------------------
# panoptic targets, criterion, matcher
# ---------------------------------------------------------------------------

def _panoptic_gt(rng, k=3000):
    """Voxels in a few instances of nyu40 classes (one class invalid, two
    instances too small), some unsupervised."""
    inst = rng.choice([0, 2, 3, 5, 9, 11, 14], size=k,
                      p=[0.2, 0.3, 0.2, 0.15, 0.1, 0.03, 0.02]).astype(np.int32)
    sem_of = {0: 0, 2: 2, 3: 4, 5: 5, 9: 13, 11: 7, 14: 6}  # 13: not valid
    sem = np.array([sem_of[i] for i in inst], np.int32)
    noise = rng.uniform(size=k) < 0.05   # minority labels inside instances
    sem = np.where(noise & (inst > 0), 39, sem).astype(np.int32)
    valid = rng.uniform(size=k) < 0.9
    return sem, inst, valid


def test_build_targets_match_jax():
    rng = np.random.default_rng(1)
    sem, inst, valid = _panoptic_gt(rng)
    want = jcrit.build_targets(jnp.asarray(sem), jnp.asarray(inst),
                               jnp.asarray(valid), 8, 100)
    got = tcrit.build_targets(t(sem), t(inst), t(valid), 8, 100)
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert 2 <= int(got.valid.sum()) < 5   # the class and size filters bite


def _predictions(rng, layers, q, k, nc=21):
    logits = rng.standard_normal((layers, q, nc)).astype(np.float32)
    masks = (2 * rng.standard_normal((layers, q, k))).astype(np.float32)
    return logits, masks


def test_criterion_matches_jax():
    """loss_labels / loss_masks at a given assignment, and set_criterion
    over 3 decoder layers (each re-matched), 1e-5."""
    rng = np.random.default_rng(2)
    sem, inst, valid = _panoptic_gt(rng)
    logits, masks = _predictions(rng, 3, 12, len(sem))
    jt = jcrit.build_targets(jnp.asarray(sem), jnp.asarray(inst),
                             jnp.asarray(valid), 8, 100)
    tt = tcrit.build_targets(t(sem), t(inst), t(valid), 8, 100)
    assign = np.where(np.asarray(jt.valid), rng.permutation(12)[:8], -1).astype(np.int32)
    _close(tcrit.loss_labels(t(logits[0]), tt, t(assign).long()),
           jcrit.loss_labels(jnp.asarray(logits[0]), jt, jnp.asarray(assign)))
    for g, w in zip(tcrit.loss_masks(t(masks[0]), tt, t(assign).long()),
                    jcrit.loss_masks(jnp.asarray(masks[0]), jt, jnp.asarray(assign))):
        _close(g, w)
    want = jcrit.set_criterion(jnp.asarray(logits), jnp.asarray(masks), jt)
    got = tcrit.set_criterion(t(logits), t(masks), tt)
    _close(got, want)
    assert float(got) > 0


def test_criterion_without_targets_is_zero():
    rng = np.random.default_rng(3)
    logits, masks = _predictions(rng, 2, 6, 50)
    tt = tcrit.build_targets(torch.zeros(50, dtype=torch.int32),
                             torch.zeros(50, dtype=torch.int32),
                             torch.ones(50, dtype=torch.bool), 4, 10)
    ml = t(masks).requires_grad_(True)
    loss = tcrit.set_criterion(t(logits), ml, tt)
    loss.backward()
    assert float(loss.detach()) == 0 and ml.grad is not None


@pytest.mark.parametrize("layers", [1, 4])
def test_auction_matches_jax_and_scipy(layers):
    """The batched auction picks, layer by layer, the assignment of the
    JAX auction_assign on the same costs; on these tie-free costs that is
    within the auction's bound of scipy's optimal cost."""
    rng = np.random.default_rng(4 + layers)
    qn, tn = 80, 48
    n_valid = [int(rng.integers(1, 40)) for _ in range(layers)]
    tgt_valid = np.zeros(tn, bool)
    tgt_valid[:max(n_valid)] = True
    cost = (3 * rng.standard_normal((layers, qn, tn))).astype(np.float32)
    costs = np.where(tgt_valid, cost, 1e9).astype(np.float32)
    got = tmatch.auction_assign(t(costs), t(tgt_valid)).numpy()
    assert got.shape == (layers, tn)
    for ly in range(layers):
        want = np.asarray(jmatch.auction_assign(jnp.asarray(costs[ly]),
                                                jnp.asarray(tgt_valid)))
        np.testing.assert_array_equal(got[ly], want)
        m = got[ly][tgt_valid]
        assert (m >= 0).all() and len(set(m.tolist())) == tgt_valid.sum()
        rows, cols = linear_sum_assignment(cost[ly][:, tgt_valid])
        best = cost[ly][:, tgt_valid][rows, cols].sum()
        mine = cost[ly][m, np.flatnonzero(tgt_valid)].sum()
        assert mine <= best + 1e-3 * tgt_valid.sum() + 1e-4


def test_match_cost_matrix_matches_jax():
    rng = np.random.default_rng(6)
    logits, masks = _predictions(rng, 2, 10, 300)
    tgt_labels = rng.integers(1, 21, 5).astype(np.int32)
    tgt_masks = (rng.uniform(size=(5, 300)) < 0.3).astype(np.float32)
    tgt_valid = np.array([1, 1, 0, 1, 1], bool)
    vm = rng.uniform(size=300) < 0.8
    got = tmatch.match_cost_matrix(t(logits), t(masks), t(tgt_labels),
                                   t(tgt_masks), t(tgt_valid), t(vm))
    for ly in range(2):
        want = jmatch.match_cost_matrix(
            jnp.asarray(logits[ly]), jnp.asarray(masks[ly]),
            jnp.asarray(tgt_labels), jnp.asarray(tgt_masks),
            jnp.asarray(tgt_valid), jnp.asarray(vm))
        _close(got[ly], want)


# ---------------------------------------------------------------------------
# GT: target volumes and synthetic fragments
# ---------------------------------------------------------------------------

def test_fuse_target_window_two_fragments():
    """Two overlapping GT windows fused into the global target volume
    (the second clamped at the edge): windows and volume exact."""
    rng = np.random.default_rng(7)
    extent, window = (12, 12, 8), (8, 8, 8)
    jt = jg.DenseTargetLevel.empty(extent)
    tt = tg.DenseTargetLevel.empty(extent)
    for origin in ((0, 0, 0), (3, 2, 5)):
        tsdf = rng.uniform(-1, 1, window).astype(np.float32)
        occ = rng.uniform(size=window) < 0.4
        fj, oj, jt = jg.fuse_target_window(jt, jnp.asarray(tsdf), jnp.asarray(occ),
                                           jnp.asarray(origin, jnp.int32))
        ft, ot, tt = tg.fuse_target_window(tt, t(tsdf), t(occ), origin)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(tt.tsdf.numpy(), np.asarray(jt.tsdf))
    np.testing.assert_array_equal(tt.occ.numpy(), np.asarray(jt.occ))


def test_synthetic_fragment_gt_matches_jax():
    """The port's GT (plain-torch TSDF fusion, analytic labels) against the
    JAX package's at a tiny size: tsdf 1e-5; occupancy and labels exact,
    except at the voxels whose projection lies on a pixel-rounding boundary
    (`torch_parity.rounding_keep_masks`): the cameras' principal point sits at a
    half-integer, so a voxel on a camera's optical plane rounds to either
    neighbour depending on the host's f32 arithmetic. Those are under 1% of
    all levels' voxels (0.3% here) and of each of levels 0 and 1; at the
    coarsest level (8^3) they are at most one voxel column (here 8 of 512,
    the column that every orbiting camera looks through)."""
    from eprecon_tpu.data import synthetic as jsyn
    from eprecon_tpu_torch.data import synthetic as tsyn

    kw = dict(n_views=3, image_hw=(48, 64), n_vox=(32, 32, 32),
              voxel_size=0.12, seed=0, start_angle=0.2)
    want, got = jsyn.make_fragment(**kw), tsyn.make_fragment(**kw)
    keeps = rounding_keep_masks(got["vol_origin_partial"], got["poses"],
                                got["intrinsics"],
                                [x.shape for x in got["tsdf_levels"]], 0.12)
    for lvl, keep in enumerate(keeps):
        np.testing.assert_allclose(got["tsdf_levels"][lvl][keep],
                                   np.asarray(want["tsdf_levels"][lvl])[keep],
                                   atol=1e-5, rtol=0, err_msg=f"tsdf {lvl}")
        np.testing.assert_array_equal(got["occ_levels"][lvl][keep],
                                      np.asarray(want["occ_levels"][lvl])[keep])
    keep0 = keeps[0]
    assert got["occ_levels"][0].sum() > 500
    for k in ("semantic", "instance"):
        np.testing.assert_array_equal(got[k][keep0], np.asarray(want[k])[keep0],
                                      err_msg=k)
    assert len(np.unique(got["instance"])) >= 3


# ---------------------------------------------------------------------------
# repairs: running statistics, writeback outside the graph
# ---------------------------------------------------------------------------

def _statistics_check(jmod, tmod, args_j, args_t):
    """Train mode with batch statistics: the port's running buffers equal
    the batch_stats flax returns (mutable=["batch_stats"]), 1e-6; eval
    mode leaves them as they were."""
    v = random_variables(jmod, *args_j, seed=3)
    load(tmod, v)
    _, upd = jmod.apply(v, *args_j, mutable=["batch_stats"])
    tmod.train()
    with torch.no_grad():
        tmod(*args_t)
    bs = upd["batch_stats"]
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        want = np.asarray(bs[key])
        assert not np.allclose(want, np.asarray(v["batch_stats"][key]))
        _close(getattr(tmod, name), want, 1e-6)
    before = [tmod.running_mean.clone(), tmod.running_var.clone()]
    tmod.eval()
    with torch.no_grad():
        tmod(*args_t)
    assert torch.equal(tmod.running_mean, before[0])
    assert torch.equal(tmod.running_var, before[1])


def test_batchnorm_updates_running_statistics():
    """layers.BatchNorm against flax nn.BatchNorm (momentum 0.99)."""
    rng = np.random.default_rng(9)
    x = (1.5 * rng.standard_normal((2, 6, 7, 8)) + 0.3).astype(np.float32)
    _statistics_check(fnn.BatchNorm(use_running_average=False), BatchNorm(8),
                      (jnp.asarray(x),), (t(x),))


def test_masked_batchnorm_updates_running_statistics():
    """dense3d.MaskedBatchNorm3d against the JAX module (momentum 0.9,
    statistics over the active voxels only)."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((8, 8, 8, 8)) + 0.5).astype(np.float32)
    m = rng.uniform(size=(8, 8, 8)) < 0.4
    _statistics_check(jd.MaskedBatchNorm3d(False), td.MaskedBatchNorm3d(8),
                      (jnp.asarray(x), jnp.asarray(m)), (t(x), t(m)))


def test_writeback_keeps_no_graph():
    """Two fragments through DenseGRUFusion with grad enabled: after the
    first backward the global map requires no grad (truncated BPTT), and
    the second fragment's backward runs."""
    rng = np.random.default_rng(11)
    tm = init_module(tg.DenseGRUFusion(8, 8), torch.Generator().manual_seed(0))
    gmap = tg.DenseGlobalLevel.empty((12, 12, 8), 16, torch.bfloat16)
    for origin in ((0, 0, 0), (2, 2, 0)):
        x = t(rng.standard_normal((8, 8, 8, 16)).astype(np.float32), torch.bfloat16)
        m = t(rng.uniform(size=(8, 8, 8)) < 0.6)
        fused, _, gmap = tm(x.requires_grad_(True), m, gmap, origin)
        fused.float().square().sum().backward()
        assert not gmap.feats.requires_grad and gmap.feats.grad_fn is None
        assert x.grad is not None and x.grad.abs().sum() > 0
