"""Module parity: each eprecon_tpu module that holds parameters (or a
kernel) against its counterpart in eprecon_tpu_torch, with the flax
variables carried over by eprecon_tpu_torch.convert.

Tolerances (relative to the largest reference value, see
torch_parity.assert_rel):
  * f32 modules: 1e-4 (summation order only);
  * bf16 modules: 2e-2 to 4e-2 (XLA:CPU and PyTorch round bf16 at other
    points, e.g. the JAX 3x3x3 conv sums three bf16-rounded 2D taps where
    cuDNN / oneDNN round once; a few roundings of 2^-9 per layer);
  * integer / boolean functions: exact.
Deep BatchNorm stacks run with use_running_average=True (random
statistics): with batch statistics, reduction-order noise is amplified by
ReLU boundary flips layer after layer (PERF_NOTES.md, spatial sharding).
"""
import jax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel, load, random_variables, t

from eprecon_tpu.models import (backbone as jbb, blocks as jb, dense3d as jd,
                                gru_fusion as jg, occupancy_init as joi,
                                unet_dense as ju)
from eprecon_tpu.models import eprecon as je
from eprecon_tpu.models.panoptic import decoder as jdec
from eprecon_tpu.models.panoptic import post as jpost
from eprecon_tpu.ops import sparse as jsp
from eprecon_tpu_torch.models import (backbone as tbb, blocks as tb,
                                      dense3d as td, gru_fusion as tg,
                                      occupancy_init as toi,
                                      unet_dense as tu)
from eprecon_tpu_torch.models import eprecon as te
from eprecon_tpu_torch.models.panoptic import decoder as tdec
from eprecon_tpu_torch.models.panoptic import post as tpost
from eprecon_tpu_torch.ops import sparse as tsp

BF16 = torch.bfloat16


def _vol(rng, shape, density=0.6):
    x = rng.standard_normal(shape).astype(np.float32)
    m = rng.uniform(size=shape[:3]) < density
    return x, m


def _run(jmod, tmod, args_j, args_t, ura=True, seed=0):
    """Random flax variables (norms and statistics included) loaded into
    the port; run both. The flax side runs jitted (a few times faster on
    the CPU than op-by-op), with Python numbers and tuples as constants."""
    v = random_variables(jmod, *args_j, seed=seed)
    load(tmod, v)
    dyn = [i for i, a in enumerate(args_j) if not isinstance(a, (int, float, tuple))]

    def apply(v, *arrays):
        full = list(args_j)
        for i, a in zip(dyn, arrays):
            full[i] = a
        if ura:
            return jmod.apply(v, *full)
        return jmod.apply(v, *full, mutable=["batch_stats"])[0]

    want = jax.jit(apply)(v, *[args_j[i] for i in dyn])
    with torch.no_grad():
        got = tmod(*args_t)
    return got, want


# ---------------------------------------------------------------------------
# dense 3D blocks
# ---------------------------------------------------------------------------

DENSE3D_CASES = {
    "subm3": (lambda: jd.SubMConv3dDense(12, 3), lambda: td.SubMConv3dDense(8, 12, 3), 2e-2),
    "subm1": (lambda: jd.SubMConv3dDense(12, 1), lambda: td.SubMConv3dDense(8, 12, 1), 2e-2),
    "masked_bn": (lambda: jd.MaskedBatchNorm3d(False), lambda: td.MaskedBatchNorm3d(8), 2e-2),
    "masked_ln": (lambda: jd.MaskedLayerNorm3d(), lambda: td.MaskedLayerNorm3d(8), 1e-4),
    "elan": (lambda: jd.Sparse3dELANDense(16), lambda: td.Sparse3dELANDense(8, 16), 3e-2),
    "residual": (lambda: jd.DenseResidualBlock(12, False),
                 lambda: td.DenseResidualBlock(8, 12, False), 3e-2),
    "residual_ura": (lambda: jd.DenseResidualBlock(8, True),
                     lambda: td.DenseResidualBlock(8, 8, True), 3e-2),
}


@pytest.mark.parametrize("case", sorted(DENSE3D_CASES))
def test_dense3d_modules(case):
    mk_j, mk_t, tol = DENSE3D_CASES[case]
    rng = np.random.default_rng(1)
    x, m = _vol(rng, (8, 8, 8, 8))
    got, want = _run(mk_j(), mk_t(), (jnp.asarray(x), jnp.asarray(m)),
                     (t(x), t(m)), ura=False)
    assert_rel(got, want, tol, case)


def test_conv_down_up():
    rng = np.random.default_rng(2)
    x, m = _vol(rng, (8, 8, 8, 6))
    got, want = _run(jd.ConvDown3dDense(10), td.ConvDown3dDense(6, 10),
                     (jnp.asarray(x), jnp.asarray(m)), (t(x), t(m)))
    assert_rel(got[0], want[0], 2e-2, "down")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    xc, mc = _vol(rng, (4, 4, 4, 6))
    got, want = _run(jd.ConvUp3dDense(10), td.ConvUp3dDense(6, 10),
                     (jnp.asarray(xc), jnp.asarray(mc), jnp.asarray(m)),
                     (t(xc), t(mc), t(m)))
    assert_rel(got, want, 2e-2, "up")


def test_dense3d_functions_exact():
    rng = np.random.default_rng(3)
    m = rng.uniform(size=(8, 8, 8)) < 0.7
    for name in ("erode", "dilate"):
        np.testing.assert_array_equal(getattr(td, name)(t(m)).numpy(),
                                      np.asarray(getattr(jd, name)(jnp.asarray(m))))
    np.testing.assert_array_equal(td.maxpool3d(t(m), 2).numpy(),
                                  np.asarray(jd.maxpool3d(jnp.asarray(m), 2)))
    x = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(td.upsample_nearest2(t(x)).numpy(),
                                  np.asarray(jd.upsample_nearest2(jnp.asarray(x))))
    np.testing.assert_allclose(td.upsample_trilinear(t(x), 4).numpy(),
                               np.asarray(jd.upsample_trilinear(jnp.asarray(x), 4)),
                               atol=1e-6)
    mm = rng.uniform(size=(8, 8, 8)) < 0.5
    xx = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tu.maxpool_mean(t(xx), 4, t(mm)).numpy(),
                               np.asarray(ju.maxpool_mean(jnp.asarray(xx), 4,
                                                          jnp.asarray(mm))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# 2D blocks and heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["linear4x_f32", "linear4x_bf16", "mlp",
                                  "conv2d_block", "fusion_block"])
def test_blocks(case):
    rng = np.random.default_rng(4)
    if case.startswith("linear4x"):
        bf = case.endswith("bf16")
        jm = jb.Linear4xTrans(16, dtype=jnp.bfloat16 if bf else None)
        tm = tb.Linear4xTrans(16, 16, dtype=BF16 if bf else None)
        x = rng.standard_normal((50, 16)).astype(np.float32)
        tol = 2e-2 if bf else 1e-4
    elif case == "mlp":
        jm, tm = jb.MLP(32, 8, 3), tb.MLP(16, 32, 8, 3)
        x = rng.standard_normal((50, 16)).astype(np.float32)
        tol = 1e-4
    elif case == "conv2d_block":
        jm, tm = jb.Conv2dBlock(12, 3), tb.Conv2dBlock(8, 12, 3)
        x = rng.standard_normal((2, 10, 12, 8)).astype(np.float32)
        tol = 2e-2
    else:
        jm, tm = jb.FusionBlock(), tb.FusionBlock(16)
        x = rng.standard_normal((2, 10, 12, 16)).astype(np.float32)
        tol = 4e-2
    got, want = _run(jm, tm, (jnp.asarray(x),), (t(x),), ura=False)
    assert_rel(got, want, tol, case)


@pytest.mark.parametrize("ura", [True, False])
def test_backbone(ura):
    """MnasMulti on two 64x96 views. Batch statistics (ura=False) run
    through ~30 BN layers in bf16: held by correlation > 0.99 and 10% of
    the scale; running statistics: 5e-2."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32) * 50
    got, want = _run(jbb.MnasMulti(1.0, ura), tbb.MnasMulti(1.0, ura),
                     (jnp.asarray(x),), (t(x),), ura=ura)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        if ura:
            assert_rel(g, w, 5e-2, "backbone")
        else:
            assert np.corrcoef(g.float().numpy().ravel(), w.ravel())[0, 1] > 0.99
            assert_rel(g, w, 0.1, "backbone")


def test_normalize_uint8():
    import __graft_entry__ as g
    from torch_parity import port_model_config

    jcfg = g._micro_cfg().model
    img = np.random.default_rng(0).integers(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    want = je.EPRecon(jcfg).normalize(jnp.asarray(img))
    got = te.EPRecon(port_model_config(jcfg)).normalize(t(img))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# occupancy init, U-Net, GRU, global fusion
# ---------------------------------------------------------------------------

def test_occupancy_init():
    """Fusion convs + variance back-projection + 3D stack (running stats).
    The JAX module sums the variance terms of its bf16 features in bf16
    (E[x^2] - E[x]^2 cancels in bf16), the port in f32, so the logits are
    held by correlation > 0.99 and 15% of the scale; the variance itself
    is held at 1e-4 in f32 by test_torch_back_project."""
    rng = np.random.default_rng(6)
    v, (h, w) = 3, (8, 12)
    feats = [rng.standard_normal((v, 1, h * 2 // s, w * 2 // s, c)).astype(np.float32)
             for s, c in ((1, 24), (2, 40), (4, 80))]
    proj = np.zeros((v, 1, 4, 4), np.float32)
    for i in range(v):
        k = np.array([[14.0, 0, (w - 1) / 2], [0, 14.0, (h - 1) / 2], [0, 0, 1]])
        pm = np.eye(4)
        pm[:3, :4] = k @ np.array([[1, 0, 0, -0.55 - 0.05 * i],
                                   [0, 1, 0, -0.52], [0, 0, 1, 1.5]])
        proj[i, 0] = pm
    origin = np.array([[0.0013, 0.0021, 0.0034]], np.float32)
    args = ((8, 8, 8), 2, 2)
    jm = joi.OccupancyInitialization(use_running_average=True)
    tm = toi.OccupancyInitialization((24, 40, 80), use_running_average=True)
    got, want = _run(jm, tm,
                     ([jnp.asarray(f) for f in feats], jnp.asarray(origin), 0.07,
                      jnp.asarray(proj), *args),
                     ([t(f) for f in feats], t(origin), 0.07, t(proj), *args))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0.2 < got[1].float().mean() < 1.0
    g, w = got[0].float().numpy(), np.asarray(want[0], np.float32)
    assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.99
    assert_rel(g, w, 0.15, "occ logits")


def test_unet():
    rng = np.random.default_rng(7)
    x, m = _vol(rng, (8, 8, 8, 11))
    got, want = _run(ju.DenseUNet(cr=0.5, use_running_average=True),
                     tu.DenseUNet(11, 0.5, True),
                     (jnp.asarray(x), jnp.asarray(m)), (t(x), t(m)))
    assert_rel(got, want, 4e-2, "unet")


def test_gru_fusion_two_fragments():
    """DenseGRUFusion reading and writing the global map twice, the second
    window overlapping the first (state threaded, writeback in place)."""
    rng = np.random.default_rng(8)
    cv, ci = 8, 8
    extent, window = (12, 12, 8), (8, 8, 8)
    jm = jg.DenseGRUFusion(cv, ci, remat=False)
    tm = tg.DenseGRUFusion(cv, ci)
    gj = jg.DenseGlobalLevel.empty(extent, cv + ci, jnp.bfloat16)
    gt = tg.DenseGlobalLevel.empty(extent, cv + ci, BF16)
    x0, m0 = _vol(rng, window + (cv + ci,))
    v = random_variables(jm, jnp.asarray(x0, jnp.bfloat16), jnp.asarray(m0), gj,
                         jnp.zeros(3, jnp.int32))
    load(tm, v)
    for origin in ((0, 0, 0), (3, 2, 5)):  # (3, 2, 5) clamps z to 0
        x, m = _vol(rng, window + (cv + ci,))
        fj, uj, gj = jm.apply(v, jnp.asarray(x, jnp.bfloat16), jnp.asarray(m),
                              gj, jnp.asarray(origin, jnp.int32))
        with torch.no_grad():
            ft, ut, gt = tm(t(x, BF16), t(m), gt, origin)
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        assert_rel(ft, fj, 2e-2, "fused")
    np.testing.assert_array_equal(gt.mask.numpy(), np.asarray(gj.mask))
    assert_rel(gt.feats, np.asarray(gj.feats, np.float32).reshape(
        *extent, cv + ci), 2e-2, "global map")


def test_fuse_tsdf_direct_exact():
    """Direct-substitute TSDF + instance fusion over two fragments."""
    rng = np.random.default_rng(9)
    extent, window = (12, 12, 8), (8, 8, 8)
    gj = jg.PanopticGlobalDense.empty(extent)
    gt = tg.PanopticGlobalDense.empty(extent)
    q = 6
    for origin in ((0, 0, 0), (2, 3, 0)):
        tsdf = rng.uniform(-1.2, 1.2, window).astype(np.float32)
        cur = rng.uniform(size=window) < 0.6
        seg = rng.integers(0, q + 1, window).astype(np.int32)
        seg_class = np.concatenate([[0], rng.integers(1, 8, q)]).astype(np.int32)
        isthing = seg_class >= 3
        valid = np.concatenate([[False], rng.uniform(size=q) < 0.8])
        args = (tsdf, cur, seg, seg_class, isthing, valid)
        gj = jg.fuse_tsdf_direct(gj, *[jnp.asarray(a) for a in args],
                                 jnp.asarray(origin, jnp.int32))
        gt = tg.fuse_tsdf_direct(gt, *[t(a) for a in args], origin)
    for f in ("tsdf", "instance", "semantic", "mask", "next_instance_id"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert int(gt.next_instance_id) > 2


# ---------------------------------------------------------------------------
# compaction, lookup, decoder, post-processing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scored,capacity", [(False, 64), (False, 400),
                                             (True, 64), (True, 400)])
def test_compact_exact(scored, capacity):
    """Compaction with and without confidence order, below and above
    capacity; scores are a permutation (tie-free)."""
    rng = np.random.default_rng(10)
    dense = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    mask = rng.uniform(size=(8, 8, 8)) < 0.4
    score = rng.permutation(512).reshape(8, 8, 8).astype(np.float32) if scored else None
    sj, oj = jsp.dense_to_sparse(jnp.asarray(dense), jnp.asarray(mask), capacity,
                                 score=None if score is None else jnp.asarray(score))
    st, ot = tsp.dense_to_sparse(t(dense), t(mask), capacity,
                                 score=None if score is None else t(score))
    for a, b in ((st.coords, sj.coords), (st.feats, sj.feats),
                 (st.valid, sj.valid), (ot, oj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back_j = jsp.sparse_to_dense(sj.coords[:, 1:], sj.feats, sj.valid, (8, 8, 8))
    back_t = tsp.sparse_to_dense(st.coords[:, 1:], st.feats, st.valid, (8, 8, 8))
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_nearest_fine_and_aligned_coords():
    rng = np.random.default_rng(11)
    rows = np.where(rng.uniform(size=(8, 8, 8)) < 0.3,
                    rng.permutation(512).reshape(8, 8, 8), -1).astype(np.int32)
    coarse = (rng.integers(0, 2, (40, 3)) * 4).astype(np.int32)
    np.testing.assert_array_equal(
        te.nearest_fine_in_cell(t(rows), t(coarse), 4).numpy(),
        np.asarray(je.nearest_fine_in_cell(jnp.asarray(rows), jnp.asarray(coarse), 4)))
    w2a = rng.standard_normal((4, 4)).astype(np.float32)
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    np.testing.assert_allclose(
        te.aligned_coord_features((4, 4, 4), 2, 0.05, t(origin), t(w2a)).numpy(),
        np.asarray(je.aligned_coord_features((4, 4, 4), 2, 0.05,
                                             jnp.asarray(origin), jnp.asarray(w2a))),
        atol=1e-5)


def test_decoder():
    """Masked transformer decoder on random compacted levels: bf16 q/k/v
    projections on both sides, f32 elsewhere -> 2e-2; attention masks are
    thresholds of mask logits, so a few may flip: check the predictions."""
    rng = np.random.default_rng(12)
    c, q, caps = 16, 8, (6, 20, 60)
    feats = [rng.standard_normal((k, c)).astype(np.float32) for k in caps]
    coords = [rng.integers(0, 16, (k, 3)).astype(np.int32) for k in caps]
    valid = [rng.uniform(size=k) < 0.8 for k in caps]
    mask_feats = rng.standard_normal((caps[2], c)).astype(np.float32)
    mask_idx = [rng.integers(0, caps[2], k).astype(np.int32) for k in caps[:2]] + \
        [np.arange(caps[2], dtype=np.int32)]
    jm = jdec.MaskedTransformerDecoder(num_classes=5, hidden_dim=c, num_queries=q,
                                       num_heads=4, dim_feedforward=32, dec_layers=3)
    tm = tdec.MaskedTransformerDecoder(num_classes=5, hidden_dim=c, num_queries=q,
                                       num_heads=4, dim_feedforward=32, dec_layers=3)
    j_args = ([jnp.asarray(f) for f in feats], [jnp.asarray(x) for x in coords],
              [jnp.asarray(x) for x in valid], jnp.asarray(mask_feats), (16, 16, 16),
              [jnp.asarray(x) for x in mask_idx])
    t_args = ([t(f) for f in feats], [t(x) for x in coords], [t(x) for x in valid],
              t(mask_feats), (16, 16, 16), [t(x).long() for x in mask_idx])
    got, want = _run(jm, tm, j_args, t_args)
    assert_rel(got.pred_logits, want.pred_logits, 2e-2, "logits")
    assert_rel(got.pred_masks, want.pred_masks, 2e-2, "masks")


def test_panoptic_inference_exact():
    rng = np.random.default_rng(13)
    q, k = 12, 300
    cls = (rng.standard_normal((q, 21)) * 3).astype(np.float32)
    cls[::3, 1] += 6.0  # some stuff queries, merged through stuff memory
    masks = rng.standard_normal((q, k)).astype(np.float32) - 4.0
    for qi in range(q):  # each query owns a (partly overlapping) band
        lo = rng.integers(0, k - 40)
        masks[qi, lo:lo + 40] += 8.0
    valid = rng.uniform(size=k) < 0.9
    want = jpost.panoptic_inference(jnp.asarray(cls), jnp.asarray(masks),
                                    jnp.asarray(valid))
    got = tpost.panoptic_inference(t(cls), t(masks), t(valid))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.seg_valid.sum() >= 2


def test_synthetic_fragment_matches():
    """The port's own copy of the synthetic fragment inputs."""
    from eprecon_tpu.data import synthetic as jsyn
    from eprecon_tpu_torch.data import synthetic as tsyn

    kw = dict(n_views=3, image_hw=(24, 32), n_vox=(16, 16, 16),
              voxel_size=0.24, seed=2, start_angle=0.3)
    want, got = jsyn.make_fragment(**kw), tsyn.make_fragment(**kw)
    for k in ("imgs", "depths", "poses", "intrinsics", "vol_origin_partial"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["proj_matrices"], want["proj_matrices"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["world_to_aligned_camera"],
                               want["world_to_aligned_camera"], atol=1e-5)
