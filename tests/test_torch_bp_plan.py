"""The back-projection kernels' launch plans (ops/back_project.py
plan_launch, plan_backward), checked on the CPU at the main path's four
call shapes and at small ones: the bricks tile the voxels, the grid fills
the card, and the shared memory and registers of the CTAs that share an SM
fit in it; the backward's channel splits cover the channels and its box
accumulator holds the boxes it takes.

The tiling below is the kernels' own index arithmetic (csrc/back_project.cu):
brick c of a window is (c // (gy*gz), c // gz % gy, c % gz) and slot l of a
brick is voxel (l // (by*bz), l // bz % by, l % bz) of it; brick c of a
coordinate list is rows c*run .. c*run + run - 1. The forward's CTA c takes
brick c; the backward's CTA c takes brick c // splits and the channel
vectors (c % splits) * cvec .. + cvec - 1.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

from eprecon_tpu_torch.ops import back_project as bp

V = 9
# (extent, channels, feature h, w, batch, mode)
PATH = {
    "occ_init_variance": ((110592,), 32, 60, 80, 1, bp.VARIANCE),
    "stage0_window": ((24, 24, 24), 80, 30, 40, 1, bp.WINDOW_MEAN),
    "stage1_window": ((48, 48, 48), 40, 60, 80, 1, bp.WINDOW_MEAN),
    "stage2_window": ((96, 96, 96), 24, 120, 160, 1, bp.WINDOW_MEAN),
}
SMALL = {
    "ragged": ((10, 12, 9), 24, 15, 20, 1, bp.WINDOW_MEAN),
    "ragged_xyz": ((11, 13, 9), 24, 15, 20, 1, bp.WINDOW_MEAN),
    "narrow": ((16, 16, 16), 8, 15, 20, 1, bp.WINDOW_MEAN),
    "wide": ((12, 12, 12), 80, 15, 20, 1, bp.WINDOW_MEAN),
    "one_voxel": ((1, 1, 1), 8, 4, 4, 1, bp.WINDOW_MEAN),
    "rows_two_batches": ((686,), 32, 15, 20, 2, bp.VARIANCE),
    "few_rows": ((3,), 16, 4, 4, 1, bp.VARIANCE),
}
ALL = {**PATH, **SMALL}


def _plan(shape):
    extent, c, h, w, b, mode = shape
    return bp.plan_launch(extent, c, V, b, mode)


def _rows_of_every_cta(extent, plan, grid=None):
    """Output rows each brick's slots map to (-1: past the edge)."""
    bvox = math.prod(plan.brick)
    cta = np.arange(plan.grid if grid is None else grid)[:, None]
    slot = np.arange(bvox)[None, :]
    if len(extent) == 1:
        rows = cta * bvox + slot
        return np.where(rows < extent[0], rows, -1)
    (dx, dy, dz), (bx, by, bz) = extent, plan.brick
    gy, gz = -(-dy // by), -(-dz // bz)
    x = cta // (gy * gz) * bx + slot // (by * bz)
    y = cta // gz % gy * by + slot // bz % by
    z = cta % gz * bz + slot % bz
    inside = (x < dx) & (y < dy) & (z < dz)
    return np.where(inside, (x * dy + y) * dz + z, -1)


@pytest.mark.parametrize("name", list(ALL))
def test_bricks_cover_every_voxel_once(name):
    extent = ALL[name][0]
    plan = _plan(ALL[name])
    rows = _rows_of_every_cta(extent, plan)
    covered = np.sort(rows[rows >= 0])
    np.testing.assert_array_equal(covered, np.arange(math.prod(extent)))
    # no CTA is wholly past the edge
    assert (rows >= 0).any(axis=1).all()


@pytest.mark.parametrize("name", list(PATH))
def test_grid_fills_the_card_twice(name):
    assert _plan(PATH[name]).grid >= 2 * 132


@pytest.mark.parametrize("name", list(ALL))
def test_resident_ctas_fit_shared_memory_and_registers(name):
    plan = _plan(ALL[name])
    assert 0 < plan.smem_bytes <= 227 * 1024
    allocated = -(-plan.smem_bytes // 128) * 128  # in 128-byte granules
    assert plan.ctas_per_sm * (allocated + 1024) <= 228 * 1024
    # registers: 4 sub-partitions of 16,384, each holding whole warps
    warps_per_partition = 16384 // (bp.REGS_PER_THREAD[ALL[name][-1], plan.items] * 32)
    assert plan.ctas_per_sm * plan.threads // 32 <= 4 * warps_per_partition


@pytest.mark.parametrize("name", list(ALL))
def test_threads_own_every_item(name):
    extent, c, h, w, b, mode = ALL[name]
    plan = _plan(ALL[name])
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= bp.MAX_THREADS
    assert 1 <= plan.items <= bp.MAX_ITEMS[mode]
    assert plan.items * plan.threads >= math.prod(plan.brick) * (c // 8)
    assert all(s & (s - 1) == 0 for s in plan.brick)  # powers of 2


@pytest.mark.parametrize("name", list(ALL))
def test_layout_regions_are_aligned_and_hold_their_contents(name):
    extent, c, h, w, b, mode = ALL[name]
    plan = _plan(ALL[name])
    _check_layout(plan.layout, bp.smem_regions(V, b, math.prod(plan.brick)))


def _check_layout(layout, sizes):
    starts, total = layout[:-1], layout[-1]
    assert len(starts) == len(sizes) and starts[0] == 0
    assert all(o % 16 == 0 for o in layout)
    ends = (*starts[1:], total)
    for (region, size), start, end in zip(sizes.items(), starts, ends):
        assert end - start >= size, region


@pytest.mark.parametrize("struct,regions", [
    ("Layout", lambda: bp.smem_regions(1, 1, 1)),
    ("BwdLayout", lambda: bp.backward_regions(1, 1, 1, 0))])
def test_layout_regions_follow_the_kernels_struct(struct, regions):
    """The kernels take the offsets in the field order of their structs."""
    src = (Path(bp.__file__).resolve().parents[1] / "csrc" / "back_project.cu").read_text()
    fields = re.search(r"struct %s \{\s*long long ([\w,\s]+);" % struct, src).group(1)
    assert [f.strip() for f in fields.split(",")] == [*regions(), "total"]


def test_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="exceed shared memory"):
        bp.plan_launch((8, 8, 8), 8, 4000, 1)
    with pytest.raises(ValueError, match="exceed shared memory"):
        bp.plan_backward_brick((8, 8, 8), 8, 4, 4, 4000, (1, 1, 1), 1)
    # the backward's bricks cannot hold the records: the per-voxel kernel
    assert bp.backward_brick_choices((8, 8, 8), 1, 4000) == []
    assert bp.plan_backward((8, 8, 8), 8, 4, 4, 4000).per_voxel


# ---------------------------------------------------------------------------
# the backward plan
# ---------------------------------------------------------------------------

def _bwd(shape):
    extent, c, h, w, b, mode = shape
    return bp.plan_backward(extent, c, h, w, V, mode)


def _backward_plans(name):
    """The window mean's brick plan for every channel split (the largest
    brick each allows), and the plan the backward takes: per-voxel where it
    takes no bricks (always for the variance's coordinate list)."""
    extent, c, h, w, b, mode = ALL[name]
    nvec = c // 8
    plans = [] if mode == bp.VARIANCE else [
        bp.plan_backward_brick(extent, c, h, w, V,
                               bp.backward_brick_choices(extent, cvec, V)[0], cvec)
        for cvec in range(1, nvec + 1) if nvec % cvec == 0]
    return plans + [_bwd(ALL[name])]


@pytest.mark.parametrize("name", list(ALL))
def test_backward_takes_bricks_only_where_they_can_pay(name):
    """Coordinate lists, and windows whose bricks cannot fill two waves of
    the card (stage 0 and the small ones), take the per-voxel kernel, whose
    threads own every (voxel, vector) item; the stage 1 and 2 windows take
    bricks."""
    extent, c, h, w, b, mode = ALL[name]
    plan = _bwd(ALL[name])
    if plan.per_voxel:
        assert plan.grid * plan.threads >= math.prod(extent) * (c // 8)
        assert (plan.grid - 1) * plan.threads < math.prod(extent) * (c // 8)
        assert plan.smem_bytes == 0
    else:
        assert len(extent) == 3 and mode == bp.WINDOW_MEAN
        assert plan.grid >= bp.MIN_WAVES * plan.ctas_per_sm * bp.SM_COUNT
    assert plan.per_voxel == (name not in ("stage1_window", "stage2_window"))


@pytest.mark.parametrize("name", list(ALL))
def test_backward_bricks_and_splits_cover_every_item_once(name):
    """Every (voxel, channel vector) belongs to exactly one CTA, for every
    channel split of the brick plans and for the per-voxel plan (thread j
    of the launch owns item j)."""
    extent, c, h, w, b, mode = ALL[name]
    nvec, n = c // 8, math.prod(extent)
    for plan in _backward_plans(name):
        hits = np.zeros((n, nvec), np.int64)
        if plan.per_voxel:
            item = np.arange(plan.grid * plan.threads)
            item = item[item < n * nvec]
            np.add.at(hits, (item // nvec, item % nvec), 1)
        else:
            splits = nvec // plan.cvec
            assert plan.grid % splits == 0 and nvec % plan.cvec == 0
            rows = _rows_of_every_cta(extent, plan, plan.grid // splits)
            assert (rows >= 0).any(axis=1).all()
            for cta in range(plan.grid):
                r = rows[cta // splits]
                vec0 = cta % splits * plan.cvec
                hits[r[r >= 0], vec0:vec0 + plan.cvec] += 1
        assert (hits == 1).all(), plan


@pytest.mark.parametrize("name", list(ALL))
def test_backward_layout_and_resources(name):
    """Brick plans: regions aligned and large enough, the per-pixel counts
    last (one more than the box's pixels: the total); the CTAs that share
    an SM fit its shared memory and registers; the threads own every
    (voxel, vector) item of a CTA. Per-voxel plans: no shared memory, and
    the CTAs their registers allow."""
    extent, c, h, w, b, mode = ALL[name]
    for plan in _backward_plans(name):
        if plan.per_voxel:
            regs = bp.PER_VOXEL_REGS_PER_THREAD[mode]
            assert plan.layout == () and plan.threads == bp.MAX_THREADS
            assert plan.ctas_per_sm == 4 * (16384 // (regs * 32)) // 8
            continue
        bvox = math.prod(plan.brick)
        sizes = bp.backward_regions(V, bvox, plan.cvec, plan.box_px)
        _check_layout(plan.layout, sizes)
        assert plan.layout[-1] - plan.layout[-2] == -(-(plan.box_px + 1) * 4 // 16) * 16
        assert 0 < plan.box_px <= min(h * w, bp.BOX_MAX_PX)  # never above an image
        allocated = -(-plan.smem_bytes // 128) * 128
        assert 0 < plan.smem_bytes <= 227 * 1024
        assert plan.ctas_per_sm * (allocated + 1024) <= 228 * 1024
        regs = bp.BWD_REGS_PER_THREAD
        assert plan.ctas_per_sm * plan.threads // 32 <= 4 * (16384 // (regs * 32))
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= bp.MAX_THREADS
        assert 1 <= plan.items <= bp.BWD_MAX_ITEMS
        assert plan.items * plan.threads >= bvox * plan.cvec


@pytest.mark.parametrize("name", list(PATH))
def test_plans_assume_the_ctas_the_card_holds(name):
    """At the main path's shapes each plan's CTAs per SM is the number the
    card's occupancy calculator gives for the modelled registers (chip_smoke
    holds it against the card): the forward and the per-voxel backward by
    registers alone (the grid does not cap it), a brick backward also by
    its shared memory, which holds exactly that many CTAs."""
    extent, c, h, w, b, mode = PATH[name]
    fwd = _plan(PATH[name])
    assert fwd.ctas_per_sm == bp._resident(fwd.threads,
                                           bp.REGS_PER_THREAD[mode, fwd.items])
    bwd = _bwd(PATH[name])
    if bwd.per_voxel:
        assert bwd.ctas_per_sm == bp._resident(
            bwd.threads, bp.PER_VOXEL_REGS_PER_THREAD[mode])
    else:
        allocated = -(-bwd.smem_bytes // 128) * 128 + 1024
        assert bwd.ctas_per_sm == min(
            bp._resident(bwd.threads, bp.BWD_REGS_PER_THREAD),
            228 * 1024 // allocated)


def test_register_table_covers_every_kernel_instance():
    """The plans model the registers of exactly the instances the library
    launches (csrc/back_project.cu pick, pick_backward, bp_backward)."""
    src = (Path(bp.__file__).resolve().parents[1] / "csrc" / "back_project.cu").read_text()
    modes = {"false": bp.WINDOW_MEAN, "true": bp.VARIANCE}
    fwd = {(modes[m], int(k)) for k, m in
           re.findall(r"return back_project_kernel<(\d), (true|false)>;", src)}
    assert fwd == set(bp.REGS_PER_THREAD)
    assert {m: max(k for mm, k in fwd if mm == m) for m in modes.values()} == bp.MAX_ITEMS
    bwd = {int(k) for k in re.findall(r"return back_project_backward_kernel<(\d)>;", src)}
    assert bwd == set(range(1, bp.BWD_MAX_ITEMS + 1))
    by_voxel = {modes[m] for m in re.findall(r"back_project_backward_by_voxel<(true|false)>", src)}
    assert by_voxel == set(bp.PER_VOXEL_REGS_PER_THREAD)


def _boxes(shape, plan, depth):
    """(rows, cols) of each brick-view's pixel box, the kernel's phase A in
    numpy: a box spans the visible voxels' corner pixels and one more to
    the right and below, clamped to the image."""
    extent, c, h, w, b, mode = shape
    rng = np.random.default_rng(0)
    n = math.prod(extent)
    dims = extent if len(extent) == 3 else (n, 1, 1)
    xyz = np.stack(np.meshgrid(*[np.arange(e) for e in dims], indexing="ij"),
                   -1).reshape(-1, 3) * 0.05
    f = 0.9 * w
    rows = _rows_of_every_cta(extent, plan, plan.grid // (c // 8 // plan.cvec))
    out = []
    for vi in range(V):
        cam = xyz - [0.3 + 0.02 * vi, 0.3, -depth] + rng.uniform(0, 1e-3, 3)
        u = cam[:, 0] / cam[:, 2] * f + (w - 1) / 2
        v = cam[:, 1] / cam[:, 2] * f + (h - 1) / 2
        vis = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (cam[:, 2] > 0)
        seen = (rows >= 0) & vis[np.maximum(rows, 0)]
        iu = np.floor(u[np.maximum(rows, 0)]).astype(np.int64)
        iv = np.floor(v[np.maximum(rows, 0)]).astype(np.int64)
        big = np.iinfo(np.int64).max
        any_ = seen.any(axis=1)
        u0, u1 = np.where(seen, iu, big).min(1), np.where(seen, iu, -1).max(1)
        v0, v1 = np.where(seen, iv, big).min(1), np.where(seen, iv, -1).max(1)
        out += list(zip((np.minimum(v1 + 1, h - 1) - v0 + 1)[any_],
                        (np.minimum(u1 + 1, w - 1) - u0 + 1)[any_]))
    return out


@pytest.mark.parametrize("name,depth", [("stage2_window", 2.0), ("stage2_window", 0.5)])
def test_backward_box_region_holds_the_boxes_it_takes(name, depth):
    """The kernel sums a brick-view per pixel in shared memory when its box
    (rows x cols pixels) has at most box_px pixels, and scatters it
    straight into the gradient otherwise: with the cameras 2 m away most
    stage-2 boxes fit, 0.5 m away some do not; the counts of each box
    taken (and the total after them) fit the region the layout gives
    them."""
    extent, c, h, w, b, mode = ALL[name]
    plan = _bwd(ALL[name])
    region = plan.layout[-1] - plan.layout[-2]
    boxes = _boxes(ALL[name], plan, depth)
    taken = [rw * cl for rw, cl in boxes if rw * cl <= plan.box_px]
    assert taken and (max(taken) + 1) * 4 <= region
    assert (plan.box_px + 1) * 4 <= region < (plan.box_px + 2) * 4 + 16
    if depth < 1:
        assert len(taken) < len(boxes)
    else:
        assert len(taken) >= 0.5 * len(boxes)
