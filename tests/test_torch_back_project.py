"""Back-projection parity: eprecon_tpu.ops.back_project against the plain
PyTorch versions in eprecon_tpu_torch.ops.back_project (which the CUDA
kernel matches bit for bit on the card, checked by chip_smoke.py).

Inputs are made with numpy from a seed. The window origin is nudged off
the voxel grid so no sample lands exactly on the |im_grid| = 1 frustum
boundary, where 1-ulp projection differences between XLA's matmul and the
port's elementwise projection would flip a view in or out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eprecon_tpu.ops import back_project as jbp
from eprecon_tpu_torch.ops import back_project as tbp

H, W = 12, 16


def _cameras(n_views, rng):
    """Views on an arc looking at a 1.6 m cube at the origin."""
    projs = []
    for i in range(n_views):
        a = 0.4 * i + rng.uniform(-0.1, 0.1)
        eye = np.array([0.8 + 2.2 * np.cos(a), 0.8 + 2.2 * np.sin(a), 1.5])
        fwd = np.array([0.8, 0.8, 0.6]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        pose = np.eye(4)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
        k = np.array([[16.0, 0, (W - 1) / 2], [0, 16.0, (H - 1) / 2], [0, 0, 1]])
        pm = np.eye(4)
        pm[:3, :4] = k @ np.linalg.inv(pose)[:3, :4]
        projs.append(pm)
    return np.stack(projs).astype(np.float32)[:, None]  # [V, 1, 4, 4]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    proj = _cameras(5, rng)
    origin = np.array([[0.0013, 0.0029, 0.0041]], np.float32)  # off-grid nudge
    return rng, proj, origin


@pytest.mark.parametrize("dim,interval,c", [((8, 8, 8), 2, 24),
                                            ((16, 16, 16), 1, 8)])
def test_window_mean_matches_jax(scene, dim, interval, c):
    """bf16 tables; JAX accumulates the views in bf16, the port in f32 with
    one final rounding: held to 2% of the feature scale (about five bf16
    roundings of terms of size ~1). Counts are exact."""
    rng, proj, origin = scene
    feats = rng.standard_normal((proj.shape[0], 1, H, W, c)).astype(np.float32)
    want_mean, want_count = jbp.back_project_window(
        dim, interval, jnp.asarray(origin), 0.1, jnp.asarray(feats),
        jnp.asarray(proj))
    got_mean, got_count = tbp.back_project_window(
        dim, interval, torch.from_numpy(origin), 0.1, torch.from_numpy(feats),
        torch.from_numpy(proj))
    assert got_mean.dtype == torch.bfloat16 and got_mean.shape == (*dim, c)
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(want_count))
    cnt = got_count.numpy()  # frustum edges cross the window:
    assert (cnt > 0).mean() > 0.3 and (cnt < len(proj)).mean() > 0.1
    np.testing.assert_allclose(got_mean.float().numpy(),
                               np.asarray(want_mean, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_variance_matches_jax(scene):
    """f32 features: both sides compute in f32 (sum and sum of squares),
    so the only differences are summation rounding: 1e-4."""
    rng, proj, origin = scene
    c = 16
    proj2 = np.concatenate([proj, _cameras(5, rng)], axis=1)  # B = 2
    origin2 = np.concatenate([origin, origin + 0.05], axis=0)
    feats = rng.standard_normal((5, 2, H, W, c)).astype(np.float32)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 16, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    coords = np.concatenate([
        np.concatenate([np.zeros((len(xyz), 1)), xyz], 1),
        np.concatenate([np.ones((len(xyz), 1)), xyz], 1)]).astype(np.int32)
    valid = rng.uniform(size=len(coords)) > 0.2
    want_var, want_count = jbp.back_project_variance(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(origin2), 0.1,
        jnp.asarray(feats), jnp.asarray(proj2))
    got_var, got_count = tbp.back_project_variance(
        torch.from_numpy(coords), torch.from_numpy(valid),
        torch.from_numpy(origin2), 0.1, torch.from_numpy(feats),
        torch.from_numpy(proj2))
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(want_count))
    assert (got_count.numpy() >= 2).mean() > 0.3
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want_var),
                               atol=1e-4, rtol=1e-4)


def test_bilinear_matches_grid_sample():
    """The sampler's align_corners=True / zero-padding convention, checked
    against torch's own grid_sample on in-frustum samples."""
    rng = np.random.default_rng(1)
    c = 8
    img = torch.from_numpy(rng.standard_normal((H, W, c)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, W - 1, 500).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, H - 1, 500).astype(np.float32))
    u[:5] = W - 1  # exact right/bottom edges
    v[5:10] = H - 1
    m = torch.ones(500, dtype=torch.bool)
    got = tbp.bilinear_sample_flat(img.reshape(H * W, c), 0, u, v, m, H, W)
    grid = torch.stack([2 * u / (W - 1) - 1, 2 * v / (H - 1) - 1], -1)
    want = torch.nn.functional.grid_sample(
        img.permute(2, 0, 1)[None], grid.view(1, 1, -1, 2),
        align_corners=True, padding_mode="zeros")[0, :, 0].T
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
