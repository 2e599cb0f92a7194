"""The port's public helpers off the model's path against their JAX
functions, on seeded numpy inputs: the coordinate-list back-projection
(`project_to_views`, `back_project_mean`), the camera helpers, the grid
helpers, the panoptic post-processing helpers, `nearest_fine_index` and
`LinearResidual` (its flax weights carried by convert). Tolerances: 1e-5
for f32 results (relative, with an absolute floor of 1e-5), exact for
integer and boolean results. The cases follow tests/test_back_project.py,
tests/test_tsdf_camera.py and tests/test_panoptic.py; their voxels sit
off the frustum's edge, where f32 rounding would decide a mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import load, t

from eprecon_tpu.models import blocks as jblocks
from eprecon_tpu.models.panoptic import post as jpost
from eprecon_tpu.models.panoptic.decoder import \
    nearest_fine_index as jax_nearest_fine_index
from eprecon_tpu.ops import back_project as jbp
from eprecon_tpu.ops import camera as jcam
from eprecon_tpu.ops import grid as jgrid
from eprecon_tpu_torch.models import blocks as tblocks
from eprecon_tpu_torch.models.panoptic import post as tpost
from eprecon_tpu_torch.models.panoptic.decoder import nearest_fine_index
from eprecon_tpu_torch.ops import back_project as tbp
from eprecon_tpu_torch.ops import camera as tcam
from eprecon_tpu_torch.ops import grid as tgrid

TOL = 1e-5


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL, atol=TOL)


def exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _coordinate_list(seed, n_views=4, bs=2, h=12, w=16, c=5, k=64, n_active=50):
    """tests/test_back_project.py's setup: pinhole cameras shifted along x,
    a coordinate list over two batch entries, the last rows invalid; the
    origin is moved by 7 mm so that no voxel projects onto the image's
    edge."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n_views, bs, h, w, c)).astype(np.float32)
    projs = []
    for v in range(n_views):
        kmat = np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]], np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.1 * v
        pm = np.eye(4, dtype=np.float32)
        pm[:3, :4] = kmat @ np.linalg.inv(pose)[:3, :4]
        projs.append(pm)
    proj = np.stack([np.stack(projs)] * bs, axis=1)
    coords = np.zeros((k, 4), np.int32)
    coords[:n_active, 0] = rng.integers(0, bs, n_active)
    coords[:n_active, 1:] = rng.integers(0, 8, (n_active, 3))
    valid = np.arange(k) < n_active
    origin = np.tile(np.array([[-0.193, -0.193, 0.507]], np.float32), (bs, 1))
    return feats, proj, coords, valid, origin, 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_project_to_views_and_back_project_mean_match_jax(seed):
    feats, proj, coords, valid, origin, vs = _coordinate_list(seed)
    h, w = feats.shape[2:4]
    juv, jmask = jbp.project_to_views(jnp.asarray(coords), jnp.asarray(valid),
                                      jnp.asarray(origin), vs, jnp.asarray(proj),
                                      h, w)
    tuv, tmask = tbp.project_to_views(t(coords), t(valid), t(origin), vs,
                                      t(proj), h, w)
    exact(tmask, jmask)
    assert 0 < int(tmask.sum()) < tmask.numel()
    close(tuv[tmask], np.asarray(juv)[np.asarray(jmask)])
    jmean, jcount = jbp.back_project_mean(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(origin), vs,
        jnp.asarray(feats), jnp.asarray(proj))
    tmean, tcount = tbp.back_project_mean(t(coords), t(valid), t(origin), vs,
                                          t(feats), t(proj))
    assert tmean.dtype == torch.float32 and tcount.dtype == torch.float32
    exact(tcount, jcount)
    close(tmean, jmean)


def _random_pose(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.standard_normal(3)
    return pose


def _intrinsics(rng):
    k = np.eye(3, dtype=np.float32)
    k[0, 0], k[1, 1] = rng.uniform(500, 600, 2)
    k[0, 2], k[1, 2] = rng.uniform(300, 340), rng.uniform(220, 260)
    return k


def test_camera_helpers_match_jax():
    """scale_intrinsics (one K and a stack), rotate_view_to_align_xyplane
    and view_frustum_points over three random poses."""
    rng = np.random.default_rng(5)
    ks = np.stack([_intrinsics(rng) for _ in range(3)])
    for k in (ks[0], ks):
        got = tcam.scale_intrinsics(k, 8.0)
        assert got.dtype == np.float32
        close(got, jcam.scale_intrinsics(jnp.asarray(k), 8.0))
    for k in ks:
        pose = _random_pose(rng)
        rot = tcam.rotate_view_to_align_xyplane(pose)
        close(rot, jcam.rotate_view_to_align_xyplane(jnp.asarray(pose)))
        up = rot @ (np.linalg.inv(pose)[:3, :3] @ np.array([0.0, 0.0, 1.0]))
        np.testing.assert_allclose(up, [0, -1, 0], atol=1e-9)
        close(tcam.view_frustum_points(3.0, (480, 640), k, pose),
              jcam.view_frustum_points(3.0, (480, 640), jnp.asarray(k),
                                       jnp.asarray(pose)))


def test_project_voxels_matches_jax():
    """Points around three cameras, some behind them and some off the
    image: uv and depth within 1e-5, the mask exactly."""
    rng = np.random.default_rng(6)
    proj = []
    for _ in range(3):
        pm = np.eye(4, dtype=np.float32)
        pm[:3, :4] = (tcam.scale_intrinsics(_intrinsics(rng), 8.0)
                      @ np.linalg.inv(_random_pose(rng))[:3, :4])
        proj.append(pm)
    proj = np.stack(proj)
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    juv, jz, jmask = jcam.project_voxels(jnp.asarray(pts), jnp.asarray(proj),
                                         (60, 80))
    tuv, tz, tmask = tcam.project_voxels(t(pts), t(proj), (60, 80))
    exact(tmask, jmask)
    assert 0 < int(tmask.sum()) < tmask.numel()
    assert (np.asarray(jz) < 0).any()
    close(tz, jz)
    close(tuv[tmask], np.asarray(juv)[np.asarray(jmask)])


@pytest.mark.parametrize("n_vox,interval", [((96, 96, 96), 2), ((24, 20, 12), 4),
                                            ((5, 6, 7), 1)])
def test_grid_helpers_match_jax(n_vox, interval):
    got, shape = tgrid.generate_grid(n_vox, interval)
    want, want_shape = jgrid.generate_grid(n_vox, interval)
    assert shape == want_shape and got.dtype == torch.float32
    exact(got, want)
    coords = tgrid.coordinates(n_vox)
    assert coords.dtype == torch.int32
    exact(coords, jgrid.coordinates(n_vox))


@pytest.mark.parametrize("panoptic_on", [True, False])
def test_semantic_and_instance_inference_match_jax(panoptic_on):
    rng = np.random.default_rng(7)
    q, k = 16, 60
    mask_cls = (2 * rng.standard_normal((q, 21))).astype(np.float32)
    mask_pred = (3 * rng.standard_normal((q, k))).astype(np.float32)
    voxel_valid = rng.uniform(size=k) < 0.8
    close(tpost.semantic_inference(t(mask_cls), t(mask_pred)),
          jpost.semantic_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred)))
    got = tpost.instance_inference(t(mask_cls), t(mask_pred), t(voxel_valid),
                                   panoptic_on=panoptic_on)
    want = jpost.instance_inference(jnp.asarray(mask_cls), jnp.asarray(mask_pred),
                                    jnp.asarray(voxel_valid),
                                    panoptic_on=panoptic_on)
    assert got.pred_classes.dtype == torch.int32
    for name in ("pred_masks", "pred_classes", "valid"):
        exact(getattr(got, name), getattr(want, name))
    close(got.scores, want.scores)
    assert bool(got.valid.any()) and (panoptic_on or bool(got.valid.all()))


@pytest.mark.parametrize("chunk", [64, 2048])
def test_nearest_fine_index_matches_jax(chunk):
    """tests/test_panoptic.py's case: integer coordinates, so distances are
    exact and ties go to the lowest row in both; the level voxels' last
    rows invalid."""
    rng = np.random.default_rng(8)
    fine = rng.integers(0, 50, (200, 3)).astype(np.int32)
    coarse = rng.integers(0, 50, (40, 3)).astype(np.int32)
    fv = np.arange(200) < 150
    cv = np.arange(40) < 36
    got = nearest_fine_index(t(coarse), t(cv), t(fine), t(fv), chunk=chunk)
    assert got.dtype == torch.int32
    exact(got, jax_nearest_fine_index(jnp.asarray(coarse), jnp.asarray(cv),
                                      jnp.asarray(fine), jnp.asarray(fv),
                                      chunk=chunk))


def test_linear_residual_takes_jax_weights():
    """Flax LinearResidual's initialised variables through convert into the
    port's module: the outputs agree to 1e-5."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((7, 12)).astype(np.float32)
    flax_mod = jblocks.LinearResidual()
    variables = flax_mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    port = load(tblocks.LinearResidual(12), variables)
    with torch.no_grad():
        close(port(t(x)), flax_mod.apply(variables, jnp.asarray(x)))
