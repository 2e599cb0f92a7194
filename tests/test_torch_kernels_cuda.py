"""The back-projection CUDA kernels, forward and backward, against their
plain PyTorch versions on the card, at small shapes (the full-size
comparison is in chip_smoke.py).
Needs an NVIDIA GPU and nvcc; skips without them. On the card (where JAX
may be missing, so skip tests/conftest.py, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import math

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
        plan = bp.plan_brick(dim, c, 4, 1, brick)
        monkeypatch.setattr(bp, "plan_launch", lambda *_, plan=plan: plan)
        (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, c)
        assert torch.equal(cnt, want_cnt) and torch.equal(got, want), brick


def test_variance_kernel_every_run_choice(cuda, monkeypatch):
    """Each row run the plan may choose (1 or 2 items per thread) agrees
    with the plain version bit for bit."""
    args = _variance_args(cuda)
    want, want_cnt = bp.back_project_variance_plain(*args)
    for run in bp.brick_choices((512,), 32, bp.VARIANCE):
        plan = bp.plan_brick((512,), 32, 4, 1, run, bp.VARIANCE)
        monkeypatch.setattr(bp, "plan_launch", lambda *_, plan=plan: plan)
        got, cnt = bp.back_project_variance(*args)
        torch.cuda.synchronize()
        assert torch.equal(cnt, want_cnt) and torch.equal(got, want), run


@pytest.mark.parametrize("dim", [(10, 12, 9), (11, 13, 9)])
def test_window_kernel_ragged_bricks(cuda, dim):
    """Window dims that are not multiples of the brick: the edge bricks
    mask their missing voxels."""
    brick = bp.plan_launch(dim, 24, 4).brick
    assert any(d % s for d, s in zip(dim, brick))
    (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, 24)
    assert torch.equal(cnt, want_cnt) and (cnt > 0).any()
    assert torch.equal(got, want)


def test_window_kernel_tallies_every_brick_view(cuda):
    """With the cameras 0.6 m from a 32^3 window some brick-views see a
    voxel and the cull or the frustum leaves others empty: the tallies
    cover every (brick, view) once, and the result is bitwise the plain
    version's."""
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    dim, h, w, c = (32, 32, 32), 64, 96, 80
    plan = bp.plan_launch(dim, c, 4)
    (got, cnt), (want, want_cnt) = _window(cuda, dim, 1, c, h, w, stats=stats,
                                           depth=0.6)
    seen, empty = stats.tolist()
    assert seen > 0 and empty > 0 and seen + empty == plan.grid * 4
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
    (batch 1's rows in reverse order, so both sides of it are visible)."""
    rng = np.random.default_rng(2)
    h, w, c = 15, 20, 32
    feats = torch.from_numpy(rng.standard_normal((4, 2, h, w, c))).to(torch.bfloat16)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 14, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    coords = torch.from_numpy(np.concatenate([
        np.concatenate([np.full((len(xyz), 1), b), xyz[::-1] if b else xyz], 1)
        for b in (0, 1)]).astype(np.int32))
    n = coords.shape[0]
    assert len(xyz) % bp.plan_launch((n,), c, 4, 2, bp.VARIANCE).brick[0]
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2)
    origin = torch.tensor([[0.002, 0.001, 0.003], [0.011, 0.004, 0.002]])
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    args = (coords.to(cuda), valid.to(cuda), origin.to(cuda), 0.05,
            feats.to(cuda), _proj(4, h, w, batch=2).to(cuda))
    got, cnt = bp.back_project_variance(*args, stats=stats)
    want, want_cnt = bp.back_project_variance_plain(*args)
    torch.cuda.synchronize()
    assert stats[0] > 0
    assert torch.equal(cnt, want_cnt) and (cnt >= 2).any()
    assert (cnt[~valid.to(cuda)] == 0).all()
    assert torch.equal(got, want)


PATH_SHAPES = [((110592,), 32, 60, 80, bp.VARIANCE),
               ((24, 24, 24), 80, 30, 40, bp.WINDOW_MEAN),
               ((48, 48, 48), 40, 60, 80, bp.WINDOW_MEAN),
               ((96, 96, 96), 24, 120, 160, bp.WINDOW_MEAN)]


@pytest.mark.parametrize("extent,c,h,w,mode", PATH_SHAPES)
def test_card_holds_the_ctas_the_plan_assumes(cuda, extent, c, h, w, mode):
    """At the main path's four call shapes the occupancy calculator, on the
    built kernels, fits as many CTAs per SM as the plans assume, forward and
    backward (the plans model each instance's registers; a brick backward
    cuts shared memory for that many)."""
    plan = bp.plan_launch(extent, c, 9, 1, mode)
    assert bp.occupancy(plan, mode) == plan.ctas_per_sm
    plan = bp.plan_backward(extent, c, h, w, 9, mode)
    assert bp.occupancy(plan, mode) == plan.ctas_per_sm
    if isinstance(plan, bp.TilePlan):  # stage 0: its clusters in one wave
        assert bp.tile_occupancy(plan)[1] >= plan.tiles
        assert bp.visible_occupancy(plan) == plan.visible_ctas_per_sm


def test_kernel_rejects_bad_input(cuda):
    feats = torch.zeros(2, 1, 4, 4, 12, device=cuda)  # 12 channels: not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        bp.back_project_window((2, 2, 2), 1, torch.zeros(1, 3, device=cuda), 0.1,
                               feats, torch.zeros(2, 1, 4, 4, device=cuda))


# ---------------------------------------------------------------------------
# backward kernel against the plain backward: both sum in 64-bit fixed
# point (integer sums in any order), so they agree bit for bit
# ---------------------------------------------------------------------------


def _equal(got, want):
    scale = want.abs().max().item()
    assert scale > 0
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got.float(), want.float()), (err, scale)


def _border_proj(h, w, v):
    """View 0 maps world (x, y) to pixel (u, v) = (x, y) at depth 1, so at
    1 m voxels the grid lands on pixel centres and the voxels at u = W - 1
    and v = H - 1 lie exactly on the frustum border (in), those one further
    exactly past it (out); the other views are perspective ones."""
    p = _proj(v, h, w)
    p[0, 0] = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0],
                            [0, 0, 0, 1.0]])
    return p


@pytest.mark.parametrize("dim,interval,voxel,c", [((12, 12, 12), 1, 1.0, 8),
                                                  ((12, 12, 12), 1, 1.0, 80),
                                                  ((16, 16, 16), 1, 0.05, 24),
                                                  ((8, 8, 8), 2, 0.05, 40)])
def test_window_backward_kernel(cuda, dim, interval, voxel, c):
    """Window-mean gradient: kernel vs plain backward, with voxels on the
    frustum border (1 m cases) and voxels no view sees (count 0)."""
    h, w, v = 10, 11, 4
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((v, 1, h, w, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((*dim, c)).astype(np.float32))
    origin = torch.zeros(1, 3) if voxel == 1.0 else torch.tensor([[0.0013, 0.0027, 0.0031]])
    proj = _border_proj(h, w, v) if voxel == 1.0 else _proj(v, h, w)
    f = feats.to(cuda).requires_grad_(True)
    before = bp.total_backward_launches()
    mean, count = bp.back_project_window(dim, interval, origin.to(cuda), voxel,
                                         f, proj.to(cuda))
    ct_bf = ct.to(cuda).to(torch.bfloat16)
    (got,) = torch.autograd.grad(mean, f, ct_bf)
    want = bp.window_backward_plain(dim, interval, origin.to(cuda), voxel,
                                    proj.to(cuda), count, ct_bf, h, w)
    torch.cuda.synchronize()
    assert bp.total_backward_launches() == before + 1
    assert (count == 0).any() and (count > 0).any()
    _equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("c", [8, 32])
def test_variance_backward_kernel_two_batches(cuda, c):
    """Variance gradient: kernel vs plain backward, batch 2, invalid rows."""
    rng = np.random.default_rng(5)
    h, w = 15, 20
    feats = torch.from_numpy(rng.standard_normal((4, 2, h, w, c))).to(torch.bfloat16)
    xyz = np.stack(np.meshgrid(*[np.arange(0, 14, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    coords = torch.from_numpy(np.concatenate([
        np.concatenate([np.full((len(xyz), 1), b), xyz], 1)
        for b in (0, 1)]).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=coords.shape[0]) > 0.2).to(cuda)
    origin = torch.tensor([[0.002, 0.001, 0.003], [0.011, 0.004, 0.002]]).to(cuda)
    proj = _proj(4, h, w, batch=2).to(cuda)
    ct = torch.from_numpy(rng.standard_normal((coords.shape[0], c))).to(
        torch.bfloat16).to(cuda)
    f = feats.to(cuda).requires_grad_(True)
    before = bp.total_backward_launches()
    var, count = bp.back_project_variance(coords, valid, origin, 0.05, f, proj)
    (through_autograd,) = torch.autograd.grad(var, f, ct)
    # the kernel's f32 gradient, before the cast to the features' bf16
    got = bp._launch_backward(bp.VARIANCE, f.detach().reshape(4, 2 * h * w, c),
                              proj.reshape(4, 2, 16), origin, coords,
                              valid.to(torch.uint8), ct, count, 4, h, w,
                              voxel_size=0.05)
    want = bp.variance_backward_plain(coords, valid, origin, 0.05, f.detach(),
                                      proj, count, ct)
    torch.cuda.synchronize()
    assert bp.total_backward_launches() == before + 2
    assert through_autograd.dtype == torch.bfloat16
    assert (count >= 2).any() and (count[~valid] == 0).all()
    _equal(got, want)
    assert got.reshape(4, 2, h, w, c)[:, 1].abs().max() > 0


def _window_backward_case(cuda, dim=(16, 16, 16), c=24, h=15, w=20, depth=1.2,
                          border=False):
    """Window-mean backward inputs; `border`: 1 m voxels and _border_proj,
    so that voxels lie exactly on u = W - 1 and v = H - 1 and one past."""
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal((4, 1, h, w, c)).astype(np.float32))
    voxel = 1.0 if border else 0.05
    origin = (torch.zeros(1, 3) if border
              else torch.tensor([[0.0013, 0.0027, 0.0031]])).to(cuda)
    proj = (_border_proj(h, w, 4) if border else _proj(4, h, w, depth=depth)).to(cuda)
    count = bp.back_project_window_plain(dim, 1, origin, voxel, feats.to(cuda),
                                         proj)[1].reshape(-1)
    ct = torch.from_numpy(rng.standard_normal((count.numel(), c))).to(
        torch.bfloat16).to(cuda)
    run = lambda **kw: bp._launch_backward(
        bp.WINDOW_MEAN, None, proj.reshape(4, 1, 16), origin, None, None, ct,
        count, 4, h, w, dim, 1, voxel, **kw)
    want = bp.window_backward_plain(dim, 1, origin, voxel, proj,
                                    count.reshape(dim), ct.reshape(*dim, c), h, w)
    return run, want, dim, c, h, w


@pytest.mark.parametrize("border", [False, True])
def test_backward_kernel_every_brick_and_split(cuda, monkeypatch, border):
    """Every brick and channel split (vectors per CTA) the window mean's
    backward plan may take agrees with the plain backward, and so do a box
    of 0 pixels (every brick-view scatters straight into the gradient) and
    every view-tile plan (channels per tile x ranges); `border`: voxels
    exactly on the last pixel column and row of view 0 and one past
    them."""
    run, want, extent, c, h, w = (_window_backward_case(cuda, (12, 12, 12), 40, 10, 11,
                                                        border=True) if border
                                  else _window_backward_case(cuda))
    nvec = c // 8
    for cvec in (d for d in range(1, nvec + 1) if nvec % d == 0):
        for brick in bp.backward_brick_choices(extent, cvec, 4):
            for px in (None, 0):
                plan = bp.plan_backward_brick(extent, c, h, w, 4, brick, cvec,
                                              box_px=px)
                monkeypatch.setattr(bp, "plan_backward", lambda *_, plan=plan: plan)
                stats = torch.zeros(3, dtype=torch.int64, device=cuda)
                got = run(stats=stats)
                torch.cuda.synchronize()
                _equal(got.reshape(want.shape), want)
                assert int(stats.sum()) == plan.grid * 4, (plan, stats)
                if px == 0:
                    assert stats[0] == 0 and stats[1] > 0
                else:
                    assert stats[0] > 0
    _every_tile_plan(monkeypatch, run, want, extent, c, h, w)


def _every_tile_plan(monkeypatch, run, want, extent, c, h, w):
    """The view-tile backward at every channel slice and number of ranges:
    bitwise equal to the plain backward, every visible pair taken once."""
    visible = None
    for cs in bp.tile_channel_choices(c, h, w):
        for ranges in range(1, bp.MAX_CLUSTER + 1):
            plan = bp.plan_tile(c, h, w, 4, cs, ranges)
            monkeypatch.setattr(bp, "plan_backward", lambda *_, plan=plan: plan)
            stats = torch.zeros(3, dtype=torch.int64, device="cuda")
            got = run(stats=stats)
            torch.cuda.synchronize()
            _equal(got.reshape(want.shape), want)
            assert stats[1:].sum() == 0 and stats[0] > 0, (plan, stats)
            visible = visible or int(stats[0])
            assert int(stats[0]) == visible, (plan, stats)


def test_backward_kernel_close_camera_takes_both_paths(cuda, monkeypatch):
    """Cameras 0.6 m from a 32^3 window at 64x96 pixels, the box cut to
    512 pixels: the far bricks' boxes fit, the near ones' do not and
    scatter straight into the gradient; both paths run and the tallies
    cover every (CTA, view) once."""
    run, want, dim, c, h, w = _window_backward_case(cuda, (32, 32, 32), 80, 64,
                                                    96, depth=0.6)
    plan = bp.plan_backward_brick(dim, c, h, w, 4, bp.backward_brick_choices(dim, 1, 4)[0],
                                  1, box_px=512)
    monkeypatch.setattr(bp, "plan_backward", lambda *_: plan)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = run(stats=stats)
    torch.cuda.synchronize()
    in_box, direct, empty = stats.tolist()
    assert in_box > 0 and direct > 0
    assert in_box + direct + empty == plan.grid * 4
    _equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("dim,c,h,w,depth", [
    ((11, 13, 9), 24, 15, 20, 1.2),   # ragged window, lists not a multiple of any range
    ((16, 16, 16), 16, 10, 11, 0.5),  # close camera: corners on the right and bottom edges
    ((7, 5, 3), 80, 6, 7, 1.2),       # few records per range, 16-channel tiles
])
def test_tile_backward_kernel_every_plan(cuda, monkeypatch, dim, c, h, w, depth):
    """The window mean's view-tile backward at every plan it may take
    agrees with the plain backward: ragged record ranges (lists whose
    length no number of ranges divides), a camera so close that visible
    voxels' corners fall past the right and bottom edges, and lists of a
    few records per range."""
    run, want, extent, c, h, w = _window_backward_case(cuda, dim, c, h, w,
                                                       depth=depth)
    _every_tile_plan(monkeypatch, run, want, extent, c, h, w)


def test_tile_backward_kernel_on_the_frustum_border(cuda, monkeypatch):
    """Voxels exactly on the last pixel column and row of view 0 (in
    frustum, their right and bottom corners skipped) and one past them
    (out): the view tiles at every plan agree with the plain backward."""
    run, want, extent, c, h, w = _window_backward_case(cuda, (12, 12, 12), 40,
                                                       10, 11, border=True)
    _every_tile_plan(monkeypatch, run, want, extent, c, h, w)


def test_tile_backward_writes_every_entry(cuda):
    """The view tiles write dT whole (the wrapper allocates it with
    torch.empty): filled with NaN in the allocator's cache first, the
    gradient comes out finite and equal to the plain backward."""
    run, want, extent, c, h, w = _window_backward_case(cuda, (24, 24, 24), 80,
                                                       30, 40)
    assert isinstance(bp.plan_backward(extent, c, h, w, 4), bp.TilePlan)
    for _ in range(3):
        junk = torch.full_like(want, float("nan"))
        del junk
        got = run()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        _equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("name", ["occ_init_variance", "stage0_window",
                                  "stage1_window", "stage2_window"])
def test_backward_kernel_path_shapes(cuda, name):
    """The four call shapes of a full-width fragment
    (tools/bench_back_project.py): kernel vs plain backward, bit for
    bit."""
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.tools import bench_back_project as bench

    frag = make_fragment(seed=0)
    (case,) = [cs for cs in bench.cases(frag["proj_matrices"],
                                        frag["vol_origin_partial"])
               if cs.name == name]
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = case.backward(stats=stats)
    want = case.backward_plain()
    torch.cuda.synchronize()
    _equal(got.reshape(want.shape), want)
    plan = bp.plan_backward(case.extent, case.c, case.h, case.w, 9, case.mode)
    if isinstance(plan, bp.TilePlan):  # stage 0: every visible pair once
        assert stats.tolist() == [case.visible, 0, 0]
    elif plan.per_voxel:  # the variance keeps no tallies
        assert int(stats.sum()) == 0
    else:
        assert stats[0] > 0


@pytest.mark.parametrize("name", ["occ_init_variance", "stage0_window",
                                  "stage1_window", "stage2_window"])
def test_backward_kernel_repeats_bit_for_bit(cuda, name):
    """Repeats of the backward on the same inputs at the four call shapes
    give the same bits: the atomics' order changes from call to call, the
    integer sums do not."""
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.tools import bench_back_project as bench

    frag = make_fragment(seed=0)
    (case,) = [cs for cs in bench.cases(frag["proj_matrices"],
                                        frag["vol_origin_partial"])
               if cs.name == name]
    first = case.backward()
    for _ in range(4):
        again = case.backward()
        torch.cuda.synchronize()
        assert torch.equal(again, first)
    assert first.abs().max() > 0


@pytest.mark.parametrize("name", ["occ_init_variance", "stage0_window",
                                  "stage2_window"])
def test_backward_kernel_non_finite_cotangent_is_nan(cuda, name):
    """A non-finite cotangent entry makes the whole gradient NaN, in the
    kernels (every design) as in the plain version."""
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.tools import bench_back_project as bench

    frag = make_fragment(seed=0)
    (case,) = [cs for cs in bench.cases(frag["proj_matrices"],
                                        frag["vol_origin_partial"])
               if cs.name == name]
    ct = case.backward.args[6]  # the bf16 cotangent, shared with the plain
    ct[5, 3] = float("inf")
    got, want = case.backward(), case.backward_plain()
    torch.cuda.synchronize()
    assert torch.isnan(got).all() and torch.isnan(want).all()


def test_train_epochs_launches_both_kernels_each_step(cuda, tmp_path):
    """train_epochs on the card at the micro config (16^3 window at 24 cm,
    16-query 1-layer decoder; 3 views at 48x64): every micro-step launches
    the forward kernel 4 times and the backward kernel 4 times."""
    import dataclasses

    from eprecon_tpu_torch.config import default_config
    from eprecon_tpu_torch.data.synthetic import make_fragment
    from eprecon_tpu_torch.models.eprecon import EPRecon
    from eprecon_tpu_torch.train.loop import train_epochs
    from eprecon_tpu_torch.train.state import Trainer

    cfg = default_config()
    m = dataclasses.replace(
        cfg.model, n_vox=(16, 16, 16), voxel_size=0.24,
        voxel_capacity=(128, 512, 2048), global_extent=(32, 32, 16),
        min_init_voxels=10, min_stage_voxels=5,
        panoptic=dataclasses.replace(cfg.model.panoptic, num_queries=16,
                                     dec_layers=1, max_instances=8,
                                     hidden_dim=16, nheads=4))
    cfg = dataclasses.replace(cfg, model=m, logdir=str(tmp_path), train=dataclasses.replace(
        cfg.train, epochs=1, accumulation_steps=2))
    samples = []
    for angle in (0.0, 0.3):
        d = make_fragment(n_views=3, image_hw=(48, 64), n_vox=m.n_vox,
                          voxel_size=m.voxel_size, start_angle=angle)
        samples.append(dict(
            scene="a", imgs=list(d["imgs"]), proj_matrices=d["proj_matrices"],
            vol_origin=d["vol_origin_partial"] - 0.48,
            vol_origin_partial=d["vol_origin_partial"],
            world_to_aligned_camera=d["world_to_aligned_camera"],
            tsdf_list=d["tsdf_levels"], occ_list=d["occ_levels"],
            semantic=d["semantic"], instance=d["instance"]))
    trainer = Trainer(cfg, EPRecon(m, seed=1), cuda, steps_per_epoch=2)
    step, launched = trainer.step, []

    def counted(*args):
        before = (bp.total_launches(), bp.total_backward_launches())
        out = step(*args)
        launched.append((bp.total_launches() - before[0],
                         bp.total_backward_launches() - before[1]))
        return out

    trainer.step = counted
    train_epochs(cfg, trainer, lambda epoch: iter(samples), log_fn=lambda _: None)
    assert launched == [(4, 4), (4, 4)]
    assert (trainer.step_count, trainer.epoch) == (2, 1)
    assert (tmp_path / "model_000000").is_file()


def test_time_fn_waits_for_work_that_returns_nothing():
    """utils.benchmark.time_fn stops its clock after the card has finished,
    also for a function that returns None: torch.cuda._sleep enqueues a
    kernel that spins for a number of clock cycles and returns at once.
    1e8 cycles take at least 50 ms at the H100's highest clock (1980 MHz);
    enqueueing them takes microseconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eprecon_tpu_torch.utils import benchmark

    torch.cuda.init()
    ms = benchmark.time_fn(lambda: torch.cuda._sleep(100_000_000), iters=3,
                           warmup=1)
    assert ms >= 40, ms


def test_sparse_engine_on_the_card_matches_the_cpu():
    """The research engine (ops/sparse.py, models/spvcnn.py) on the card
    against its own CPU run: the plans' coordinate sets, neighbour maps
    and links are equal (the table's representative row, the largest,
    does not depend on the order of the card's writes), the per-point
    output within 1e-4 of its scale (f32 sums in another order; TF32 is
    off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eprecon_tpu_torch.models import spvcnn
    from eprecon_tpu_torch.ops import sparse as sp

    rng = np.random.default_rng(0)
    n, cap, c = 3000, 4096, 16
    xyz = np.concatenate([rng.uniform(0, 2.0, (n, 3)),
                          np.zeros((cap - n, 3))]).astype(np.float32)
    feats = rng.standard_normal((cap, c)).astype(np.float32)
    valid = np.arange(cap) < n
    out = {}
    for dev in ("cpu", "cuda"):
        pts = sp.PointSet(torch.tensor(xyz, device=dev),
                          torch.zeros(cap, dtype=torch.int32, device=dev),
                          torch.tensor(feats, device=dev),
                          torch.tensor(valid, device=dev))
        plan = spvcnn.build_plan(pts, vres=0.1)
        model = spvcnn.SPVCNN(c, cr=0.5, seed=1, device=dev)
        out[dev] = (plan, model(pts.feats, plan).detach())
    (pc, yc), (pg, yg) = out["cpu"], out["cuda"]
    for lc, lg in zip(pc.levels, pg.levels):
        for a, b in zip(lc, lg):
            if a is not None:
                assert torch.equal(a.voxels.coords if hasattr(a, "voxels") else a,
                                   (b.voxels.coords if hasattr(b, "voxels") else b).cpu())
    scale = yc.abs().max().item()
    assert (yg.cpu() - yc).abs().max().item() <= 1e-4 * scale
