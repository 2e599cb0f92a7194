"""The back-projection CUDA kernel against its plain PyTorch version on the
card, at small shapes (the full-size comparison is in chip_smoke.py).
Needs an NVIDIA GPU and nvcc; skips without them. On the card (where JAX
may be missing, so skip tests/conftest.py, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from eprecon_tpu_torch.ops import back_project as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eprecon_tpu_torch import kernels
    try:
        kernels.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _proj(v, h, w, depth=1.2, focal=2.0, batch=1):
    """Views looking down +z at the window from `depth` in front of it,
    focal length `focal` image widths; batch element i shifted 3 cm."""
    out = np.zeros((v, batch, 4, 4), np.float32)
    for i in range(v):
        for b in range(batch):
            k = np.array([[w * focal, 0, (w - 1) / 2], [0, w * focal, (h - 1) / 2],
                          [0, 0, 1]])
            out[i, b] = np.eye(4)
            out[i, b, :3, :4] = k @ np.array([[1, 0, 0, -0.4 - 0.05 * i - 0.03 * b],
                                              [0, 1, 0, -0.35], [0, 0, 1, depth]])
    return torch.from_numpy(out)


def _window(cuda, dim, interval, c, h=15, w=20, v=4, seed=0, stats=None, **cam):
    """Kernel and plain window means on the same inputs."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((v, 1, h, w, c)).astype(np.float32))
    origin = torch.tensor([[0.0013, 0.0027, 0.0031]])
    args = (dim, interval, origin.to(cuda), 0.05, feats.to(cuda),
            _proj(v, h, w, **cam).to(cuda))
    before = bp.total_launches()
    got = bp.back_project_window(*args, stats=stats)
    want = bp.back_project_window_plain(*args)
    torch.cuda.synchronize()
    assert bp.total_launches() == before + 1
    return got, want


@pytest.mark.parametrize("dim,interval,c", [((16, 16, 16), 1, 24),
                                            ((8, 8, 8), 2, 40),
                                            ((16, 16, 16), 1, 8),
                                            ((12, 12, 12), 2, 80)])
def test_window_kernel_bitwise(cuda, dim, interval, c):
    (got, cnt), (want, want_cnt) = _window(cuda, dim, interval, c)
    assert torch.equal(cnt, want_cnt) and (cnt > 0).any() and (cnt < 4).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [24, 40, 80])
def test_window_kernel_every_brick_choice(cuda, monkeypatch, c):
    """Each brick the plan may choose (1 to 3 items per thread) agrees with
    the plain version bit for bit."""
    dim = (16, 16, 16)
    for brick in bp.brick_choices(dim, c, bp.WINDOW_MEAN):
        plan = bp.plan_brick(dim, c, 15, 20, 4, 1, brick)
        monkeypatch.setattr(bp, "plan_launch", lambda *_, plan=plan: plan)
        (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, c)
        assert torch.equal(cnt, want_cnt) and torch.equal(got, want), brick


def test_variance_kernel_every_run_choice(cuda, monkeypatch):
    """Each row run the plan may choose (1 or 2 items per thread) agrees
    with the plain version bit for bit."""
    args = _variance_args(cuda)
    want, want_cnt = bp.back_project_variance_plain(*args)
    for run in bp.brick_choices((512,), 32, bp.VARIANCE):
        plan = bp.plan_brick((512,), 32, 15, 20, 4, 1, run)
        monkeypatch.setattr(bp, "plan_launch", lambda *_, plan=plan: plan)
        got, cnt = bp.back_project_variance(*args)
        torch.cuda.synchronize()
        assert torch.equal(cnt, want_cnt) and torch.equal(got, want), run


@pytest.mark.parametrize("dim", [(10, 12, 9), (11, 13, 9)])
def test_window_kernel_ragged_bricks(cuda, dim):
    """Window dims that are not multiples of the brick: the edge bricks
    mask their missing voxels."""
    brick = bp.plan_launch(dim, 24, 15, 20, 4).brick
    assert any(d % s for d, s in zip(dim, brick))
    (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, 24)
    assert torch.equal(cnt, want_cnt) and (cnt > 0).any()
    assert torch.equal(got, want)


def test_window_kernel_large_boxes_fall_back(cuda):
    """With 80 channels a staging buffer holds ~170 pixels, and with the
    cameras 0.6 m from the window the bricks nearest them project onto
    larger boxes: those brick-views read their corners from device memory,
    the far ones stage. Both paths must run and agree with the plain
    version bit for bit."""
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    dim, h, w, c = (32, 32, 32), 64, 96, 80
    plan = bp.plan_launch(dim, c, h, w, 4)
    assert plan.patch_bytes < h * w * c * 2  # a box can outgrow a buffer
    (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, c, h, w, stats=stats,
                                           depth=0.6)
    staged, from_memory, empty = stats.tolist()
    assert staged > 0 and from_memory > 0
    assert staged + from_memory + empty == plan.grid * 4
    assert torch.equal(cnt, want_cnt) and (cnt > 0).any()
    assert torch.equal(got, want)


def _variance_args(cuda, h=15, w=20, c=32):
    """512 rows of an 8^3 grid, 10% invalid, one batch element."""
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((4, 1, h, w, c))).to(torch.bfloat16)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 16, 2)] * 3, indexing="ij"), -1)
    coords = torch.from_numpy(np.concatenate(
        [np.zeros((512, 1)), xyz.reshape(-1, 3)], 1).astype(np.int32))
    valid = torch.from_numpy(rng.uniform(size=512) > 0.1)
    return (coords.to(cuda), valid.to(cuda), torch.tensor([[0.002, 0.001, 0.003]]).to(cuda),
            0.05, feats.to(cuda), _proj(4, h, w).to(cuda))


def test_variance_kernel_bitwise(cuda):
    args = _variance_args(cuda)
    got, cnt = bp.back_project_variance(*args)
    want, want_cnt = bp.back_project_variance_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(cnt, want_cnt) and (cnt >= 2).any()
    assert torch.equal(got, want)


def test_variance_kernel_two_batches_bitwise(cuda):
    """B = 2 with invalid rows: the batch boundary falls inside a row run
    (batch 1's rows in reverse order, so both sides of it are visible),
    whose views read device memory; the other runs stage."""
    rng = np.random.default_rng(2)
    h, w, c = 15, 20, 32
    feats = torch.from_numpy(rng.standard_normal((4, 2, h, w, c))).to(torch.bfloat16)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 14, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    coords = torch.from_numpy(np.concatenate([
        np.concatenate([np.full((len(xyz), 1), b), xyz[::-1] if b else xyz], 1)
        for b in (0, 1)]).astype(np.int32))
    n = coords.shape[0]
    assert len(xyz) % bp.plan_launch((n,), c, h, w, 4, 2, bp.VARIANCE).brick[0]
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2)
    origin = torch.tensor([[0.002, 0.001, 0.003], [0.011, 0.004, 0.002]])
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    args = (coords.to(cuda), valid.to(cuda), origin.to(cuda), 0.05,
            feats.to(cuda), _proj(4, h, w, batch=2).to(cuda))
    got, cnt = bp.back_project_variance(*args, stats=stats)
    want, want_cnt = bp.back_project_variance_plain(*args)
    torch.cuda.synchronize()
    assert stats[0] > 0 and stats[1] > 0
    assert torch.equal(cnt, want_cnt) and (cnt >= 2).any()
    assert (cnt[~valid.to(cuda)] == 0).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("extent,c,h,w,mode", [
    ((110592,), 32, 60, 80, bp.VARIANCE),
    ((24, 24, 24), 80, 30, 40, bp.WINDOW_MEAN),
    ((48, 48, 48), 40, 60, 80, bp.WINDOW_MEAN),
    ((96, 96, 96), 24, 120, 160, bp.WINDOW_MEAN)])
def test_card_holds_the_ctas_the_plan_assumes(cuda, extent, c, h, w, mode):
    """At the main path's four call shapes the occupancy calculator, on the
    built kernel, fits as many CTAs per SM as the plan cut shared memory
    for."""
    plan = bp.plan_launch(extent, c, h, w, 9, 1, mode)
    assert bp.occupancy(plan, mode) == plan.ctas_per_sm


def test_kernel_rejects_bad_input(cuda):
    feats = torch.zeros(2, 1, 4, 4, 12, device=cuda)  # 12 channels: not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        bp.back_project_window((2, 2, 2), 1, torch.zeros(1, 3, device=cuda), 0.1,
                               feats, torch.zeros(2, 1, 4, 4, device=cuda))
