"""Back-projection gradients: the port's plain backward against autograd of
its plain forward, and the port's CPU gradient (the autograd.Functions of
eprecon_tpu_torch.ops.back_project) against jax.grad of the JAX package's
back-projection, under both of its adjoints (`bp_backward`). The CUDA
backward kernel is held against the plain backward on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Inputs are made with numpy from a seed; the cameras and the origin nudge
are those of tests/test_torch_back_project.py, so no sample lies on a
frustum border where 1-ulp projection differences would flip a view.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_back_project import H, W, _cameras

from eprecon_tpu.ops import back_project as jbp
from eprecon_tpu_torch.ops import back_project as tbp

MODES = ["scatter", "sorted"]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    proj = _cameras(5, rng)
    origin = np.array([[0.0013, 0.0029, 0.0041]], np.float32)
    return proj, origin


def _variance_inputs(proj, origin, c, seed):
    """Batch 2 (the second batch element's cameras and origin shifted),
    a stride-2 grid per batch element, 20% of the rows invalid. f32
    features with no ties (continuous random values)."""
    rng = np.random.default_rng(seed)
    proj2 = np.concatenate([proj, _cameras(5, rng)], axis=1)
    origin2 = np.concatenate([origin, origin + 0.05], axis=0)
    feats = rng.standard_normal((5, 2, H, W, c)).astype(np.float32)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 16, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    coords = np.concatenate([
        np.concatenate([np.full((len(xyz), 1), b), xyz], 1)
        for b in (0, 1)]).astype(np.int32)
    valid = rng.uniform(size=len(coords)) > 0.2
    ct = rng.standard_normal((len(coords), c)).astype(np.float32)
    return coords, valid, origin2, feats, proj2, ct


def test_window_plain_backward_is_autograd(scene):
    """The explicit window backward equals autograd of the plain forward
    on an f32 table (f32 throughout: 1e-5 of the gradient's scale)."""
    proj, origin = scene
    rng = np.random.default_rng(0)
    dim, c = (8, 8, 8), 16
    feats = torch.from_numpy(rng.standard_normal((5, 1, H, W, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((*dim, c)).astype(np.float32))
    feats.requires_grad_(True)
    mean, count = tbp.back_project_window_plain(
        dim, 2, torch.from_numpy(origin), 0.1, feats, torch.from_numpy(proj),
        table_dtype=torch.float32)
    (want,) = torch.autograd.grad(mean, feats, ct)
    got = tbp.window_backward_plain(dim, 2, torch.from_numpy(origin), 0.1,
                                    torch.from_numpy(proj), count, ct, H, W)
    assert (count > 0).float().mean() > 0.3 and (count < 5).float().mean() > 0.1
    assert _rel_err(got.reshape(want.shape), want) < 1e-5


def test_variance_plain_backward_is_autograd(scene):
    """The explicit variance backward (re-sampled, clamp rule) equals
    autograd of the plain forward, f32, batch 2 with invalid rows: 1e-5."""
    coords, valid, origin2, feats, proj2, ct = _variance_inputs(*scene, 16, 1)
    f = torch.from_numpy(feats).requires_grad_(True)
    args = (torch.from_numpy(coords), torch.from_numpy(valid),
            torch.from_numpy(origin2), 0.1)
    var, count = tbp.back_project_variance_plain(*args, f, torch.from_numpy(proj2))
    (want,) = torch.autograd.grad(var, f, torch.from_numpy(ct))
    got = tbp.variance_backward_plain(*args, f.detach(), torch.from_numpy(proj2),
                                      count, torch.from_numpy(ct))
    assert (count.numpy() >= 2).mean() > 0.3
    assert _rel_err(got.reshape(want.shape), want) < 1e-5
    assert np.abs(want.numpy()).max() > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim,interval,c", [((8, 8, 8), 2, 24),
                                            ((16, 16, 16), 1, 8)])
def test_window_gradient_matches_jax(scene, mode, dim, interval, c):
    """The port's CPU gradient of back_project_window against jax.grad.
    JAX samples with bf16 weights and accumulates the table's gradient in
    bf16 (a bf16 scatter of up to ~100 terms per pixel here); the port
    accumulates in f32 and rounds once: held to 5e-2 of the gradient's
    largest entry."""
    proj, origin = scene
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((5, 1, H, W, c)).astype(np.float32)
    ct = rng.standard_normal((*dim, c)).astype(np.float32)

    def loss(f):
        mean, _ = jbp.back_project_window(dim, interval, jnp.asarray(origin),
                                          0.1, f, jnp.asarray(proj),
                                          bp_backward=mode)
        return jnp.sum(mean.astype(jnp.float32) * ct)

    want = jax.grad(loss)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    mean, _ = tbp.back_project_window(dim, interval, torch.from_numpy(origin),
                                      0.1, f, torch.from_numpy(proj))
    (mean.float() * torch.from_numpy(ct)).sum().backward()
    assert f.grad.dtype == torch.float32 and f.grad.shape == f.shape
    assert _rel_err(f.grad.numpy(), want) < 5e-2
    assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("mode", MODES)
def test_variance_gradient_matches_jax(scene, mode):
    """The port's CPU gradient of back_project_variance against jax.grad,
    f32 inputs, batch 2 with invalid rows: 1e-4. (At an exact var == 0
    with s_v != mean torch's clamp passes the gradient where JAX's maximum
    halves it; continuous random features have no such tie.)"""
    coords, valid, origin2, feats, proj2, ct = _variance_inputs(*scene, 16, 2)

    def loss(f):
        var, _ = jbp.back_project_variance(
            jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(origin2), 0.1,
            f, jnp.asarray(proj2), bp_backward=mode)
        return jnp.sum(var * ct)

    want = jax.grad(loss)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    var, _ = tbp.back_project_variance(
        torch.from_numpy(coords), torch.from_numpy(valid),
        torch.from_numpy(origin2), 0.1, f, torch.from_numpy(proj2))
    (var * torch.from_numpy(ct)).sum().backward()
    assert _rel_err(f.grad.numpy(), want) < 1e-4
    # invalid rows and the second batch element both reach the gradient
    assert np.abs(f.grad.numpy()[:, 1]).max() > 0


def test_count_gets_no_gradient(scene):
    """The view count is not differentiable, and a CPU backward launches
    no kernel."""
    proj, origin = scene
    feats = torch.ones(5, 1, H, W, 8, requires_grad=True)
    before = tbp.total_backward_launches()
    mean, count = tbp.back_project_window((4, 4, 4), 4, torch.from_numpy(origin),
                                          0.1, feats, torch.from_numpy(proj))
    assert mean.requires_grad and not count.requires_grad
    mean.float().sum().backward()
    assert tbp.total_backward_launches() == before
