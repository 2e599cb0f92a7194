"""The back-projection kernels' launch plans (ops/back_project.py
plan_launch, plan_backward, view_tile_plan), checked on the CPU at the main
path's four call shapes and at small ones: the bricks tile the voxels, the
grid fills the card, and the shared memory and registers of the CTAs that
share an SM fit in it; the backward's channel splits cover the channels and
its box accumulator holds the boxes it takes; the view tiles cover every
(view, channel, visible record) once, in one wave of clusters.

The tiling below is the kernels' own index arithmetic (csrc/back_project.cu):
brick c of a window is (c // (gy*gz), c // gz % gy, c % gz) and slot l of a
brick is voxel (l // (by*bz), l // bz % by, l % bz) of it; brick c of a
coordinate list is rows c*run .. c*run + run - 1. The forward's CTA c takes
brick c; the backward's CTA c takes brick c // splits and the channel
vectors (c % splits) * cvec .. + cvec - 1. The view-tile backward's CTA c
is rank c % ranges of tile c // ranges, tile t is channels
(t % (C / cs)) * cs .. + cs - 1 of view t // (C / cs), and rank r takes
places r * ceil(m / ranges) .. of the view's m visible records.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

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
    ("BwdLayout", lambda: bp.backward_regions(1, 1, 1, 0)),
    ("TileLayout", lambda: bp.tile_regions(1, 1, 2))])
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
    # the backward's bricks cannot hold the records: view tiles, which
    # hold one view at a time
    assert bp.backward_brick_choices((8, 8, 8), 1, 4000) == []
    assert isinstance(bp.plan_backward((8, 8, 8), 8, 4, 4, 4000), bp.TilePlan)
    # no tile of any slice holds 60,000 pixels
    with pytest.raises(ValueError, match="no view tile fits"):
        bp.view_tile_plan(8, 200, 300, 9)


# ---------------------------------------------------------------------------
# the backward plan
# ---------------------------------------------------------------------------

def _bwd(shape):
    extent, c, h, w, b, mode = shape
    return bp.plan_backward(extent, c, h, w, V, mode)


def _backward_plans(name):
    """The window mean's brick plan for every channel split (the largest
    brick each allows), and the plan the backward takes: per-voxel for the
    variance's coordinate list, view tiles for a window whose bricks cannot
    pay."""
    extent, c, h, w, b, mode = ALL[name]
    nvec = c // 8
    plans = [] if mode == bp.VARIANCE else [
        bp.plan_backward_brick(extent, c, h, w, V,
                               bp.backward_brick_choices(extent, cvec, V)[0], cvec)
        for cvec in range(1, nvec + 1) if nvec % cvec == 0]
    return plans + [_bwd(ALL[name])]


@pytest.mark.parametrize("name", list(ALL))
def test_backward_takes_bricks_only_where_they_can_pay(name):
    """Coordinate lists (the variance) take the per-voxel kernel, whose
    threads own every (voxel, vector) item; windows whose bricks cannot
    fill two waves of the card (stage 0 and the small ones) take view
    tiles; the stage 1 and 2 windows take bricks."""
    extent, c, h, w, b, mode = ALL[name]
    plan = _bwd(ALL[name])
    if isinstance(plan, bp.TilePlan):
        assert len(extent) == 3 and mode == bp.WINDOW_MEAN
        assert plan == bp.view_tile_plan(c, h, w, V)
    elif plan.per_voxel:
        assert mode == bp.VARIANCE
        assert plan.grid * plan.threads >= math.prod(extent) * (c // 8)
        assert (plan.grid - 1) * plan.threads < math.prod(extent) * (c // 8)
        assert plan.smem_bytes == 0
    else:
        assert len(extent) == 3 and mode == bp.WINDOW_MEAN
        assert plan.grid >= bp.MIN_WAVES * plan.ctas_per_sm * bp.SM_COUNT
    assert isinstance(plan, bp.TilePlan) == (
        mode == bp.WINDOW_MEAN and name not in ("stage1_window", "stage2_window"))


@pytest.mark.parametrize("name", list(ALL))
def test_backward_bricks_and_splits_cover_every_item_once(name):
    """Every (voxel, channel vector) belongs to exactly one CTA, for every
    channel split of the brick plans and for the per-voxel plan (thread j
    of the launch owns item j); view tiles cover every (view, channel,
    record) once (test_tile_plan_covers_every_view_channel_and_record_once)."""
    extent, c, h, w, b, mode = ALL[name]
    nvec, n = c // 8, math.prod(extent)
    for plan in _backward_plans(name):
        if isinstance(plan, bp.TilePlan):
            continue
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
        if isinstance(plan, bp.TilePlan):
            _check_tile_resources(plan, h, w)
            continue
        if plan.per_voxel:
            regs = bp.PER_VOXEL_REGS_PER_THREAD
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
    its shared memory, which holds exactly that many CTAs, and view tiles
    by shared memory and registers, the visible-records pass by
    registers."""
    extent, c, h, w, b, mode = PATH[name]
    fwd = _plan(PATH[name])
    assert fwd.ctas_per_sm == bp._resident(fwd.threads,
                                           bp.REGS_PER_THREAD[mode, fwd.items])
    bwd = _bwd(PATH[name])
    if isinstance(bwd, bp.TilePlan):
        allocated = -(-bwd.smem_bytes // 128) * 128 + 1024
        assert bwd.ctas_per_sm == min(
            bp._resident(bwd.threads, bp.TILE_REGS_PER_THREAD[bwd.cs]),
            228 * 1024 // allocated)
        assert bwd.visible_ctas_per_sm == bp._resident(
            bp.MAX_THREADS, bp.VISIBLE_REGS_PER_THREAD)
    elif bwd.per_voxel:
        assert bwd.ctas_per_sm == bp._resident(
            bwd.threads, bp.PER_VOXEL_REGS_PER_THREAD)
    else:
        allocated = -(-bwd.smem_bytes // 128) * 128 + 1024
        assert bwd.ctas_per_sm == min(
            bp._resident(bwd.threads, bp.BWD_REGS_PER_THREAD),
            228 * 1024 // allocated)


def test_register_table_covers_every_kernel_instance():
    """The plans model the registers of exactly the instances the library
    launches (csrc/back_project.cu pick, pick_backward, pick_tile, the
    visible-records pass and the variance's per-voxel kernel)."""
    src = (Path(bp.__file__).resolve().parents[1] / "csrc" / "back_project.cu").read_text()
    modes = {"false": bp.WINDOW_MEAN, "true": bp.VARIANCE}
    fwd = {(modes[m], int(k)) for k, m in
           re.findall(r"return back_project_kernel<(\d), (true|false)>;", src)}
    assert fwd == set(bp.REGS_PER_THREAD)
    assert {m: max(k for mm, k in fwd if mm == m) for m in modes.values()} == bp.MAX_ITEMS
    bwd = {int(k) for k in re.findall(r"return back_project_backward_kernel<(\d)>;", src)}
    assert bwd == set(range(1, bp.BWD_MAX_ITEMS + 1))
    tiles = {int(k) for k in re.findall(r"return back_project_backward_tile<(\d+)>;", src)}
    assert tiles == set(bp.TILE_REGS_PER_THREAD)
    # one instance each, no template: the table holds a number
    for kernel, regs in (("back_project_backward_by_voxel", bp.PER_VOXEL_REGS_PER_THREAD),
                         ("back_project_backward_visible", bp.VISIBLE_REGS_PER_THREAD)):
        assert re.search(r"void __launch_bounds__\(kMaxThreads\) %s\(" % kernel, src)
        assert isinstance(regs, int) and regs % 8 == 0


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


# ---------------------------------------------------------------------------
# the window mean's view tiles
# ---------------------------------------------------------------------------

WINDOWS = [name for name, shape in ALL.items() if shape[-1] == bp.WINDOW_MEAN]


def _tile_plans(name):
    """Every plan the view tiles may take at a window shape: each channel
    slice with each number of ranges."""
    extent, c, h, w, b, mode = ALL[name]
    return [bp.plan_tile(c, h, w, V, cs, k)
            for cs in bp.tile_channel_choices(c, h, w)
            for k in range(1, bp.MAX_CLUSTER + 1)]


def _check_tile_resources(plan, h, w):
    """Shared memory fits one CTA and the resident CTAs the plan assumes;
    registers hold its threads; the layout is the tile's."""
    _check_layout(plan.layout, bp.tile_regions(h, w, plan.cs))
    assert 0 < plan.smem_bytes <= bp.SMEM_MAX
    allocated = -(-plan.smem_bytes // 128) * 128
    assert plan.ctas_per_sm >= 1
    assert plan.ctas_per_sm * (allocated + 1024) <= 228 * 1024
    regs = bp.TILE_REGS_PER_THREAD[plan.cs]
    assert plan.ctas_per_sm * plan.threads // 32 <= 4 * (16384 // (regs * 32))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= bp.TILE_MAX_THREADS


@pytest.mark.parametrize("name", WINDOWS)
def test_tile_plans_fit_shared_memory_and_the_resident_ctas(name):
    extent, c, h, w, b, mode = ALL[name]
    for plan in _tile_plans(name):
        _check_tile_resources(plan, h, w)
        # a cluster of `ranges` CTAs per tile: the cluster size divides the grid
        assert 1 <= plan.ranges <= bp.MAX_CLUSTER
        assert plan.grid % plan.ranges == 0 and plan.grid == plan.tiles * plan.ranges
        assert plan.tiles == V * (c // plan.cs) and c % plan.cs == 0


def _tile_hits(plan, v, c, m):
    """hits[view, channel, record] of every lane of every CTA of `plan` over
    lists of m records per view, by the kernel's index arithmetic."""
    lp = min(plan.cs, 8)
    r = 32 // lp
    hits = np.zeros((v, c, m), np.int64)
    for cta in range(plan.grid):
        tile, rank = divmod(cta, plan.ranges)
        view, sl = divmod(tile, c // plan.cs)
        part = -(-m // plan.ranges)
        i0 = min(m, rank * part)
        mm = min(m, i0 + part) - i0
        q = -(-mm // r)
        for slot in range(r):
            cols = np.arange(max(0, min(q, mm - slot * q)))
            for e in range(lp):
                for ch in range(e, plan.cs, lp):
                    hits[view, sl * plan.cs + ch, i0 + slot * q + cols] += 1
    return hits


@pytest.mark.parametrize("m", [0, 1, 31, 333, 1200])
def test_tile_plan_covers_every_view_channel_and_record_once(m):
    """Each (view, channel, visible record) is added by exactly one lane of
    one CTA, for every channel slice and number of ranges, lists of any
    length (ragged last ranges and columns included)."""
    c, v = 16, 3
    for cs in bp.tile_channel_choices(c, 6, 7):
        for k in (1, 2, 3, 5, 8):
            plan = bp.plan_tile(c, 6, 7, v, cs, k)
            assert (_tile_hits(plan, v, c, m) == 1).all(), (cs, k)


@pytest.mark.parametrize("name", WINDOWS)
def test_tile_plan_takes_the_most_ctas_in_one_wave(name):
    """view_tile_plan: of the plans whose grid fits one wave of resident
    CTAs, the largest grid (the most channels per tile among equals); at
    stage 0, 8 channels x 2 ranges (180 CTAs, 2 per SM: the int64 tile of
    16 channels, 153.6 KB, leaves room for one CTA per SM); at stage 2
    none (19,200 pixels of 2 int64 channels exceed a CTA's shared memory:
    its window takes bricks)."""
    extent, c, h, w, b, mode = ALL[name]
    if not bp.tile_channel_choices(c, h, w):
        assert name == "stage2_window"
        with pytest.raises(ValueError, match="no view tile fits"):
            bp.view_tile_plan(c, h, w, V)
        return
    plan = bp.view_tile_plan(c, h, w, V)
    one_wave = [p for p in _tile_plans(name)
                if p.grid <= p.ctas_per_sm * bp.SM_COUNT]
    assert plan.grid <= plan.ctas_per_sm * bp.SM_COUNT
    assert all((p.grid, p.cs) <= (plan.grid, plan.cs) for p in one_wave)
    if name == "stage0_window":
        assert (plan.cs, plan.ranges, plan.grid, plan.ctas_per_sm) == (8, 2, 180, 2)


def test_tile_layout_rotation_is_a_permutation_of_each_pixel():
    """Pixel px's channel c sits at px * cs + (c + px) mod cs: within each
    pixel's block a permutation (the LP lanes of a record fall on LP
    banks), and where two pixels' blocks start on the same bank but px
    differs mod cs (cs of 8 and 16), channel c of the two on other banks."""
    for cs in bp.TILE_REGS_PER_THREAD:
        px = np.arange(256)[:, None]
        at = px * cs + (np.arange(cs)[None, :] + px) % cs
        assert (np.sort(at, axis=1) == px * cs + np.arange(cs)).all()
        same_start = (px * cs) % 32 == (px.T * cs) % 32
        apart = px % cs != px.T % cs
        for ch in range(cs):
            bank = at[:, ch] % 32
            clash = bank[:, None] == bank[None, :]
            assert not (clash & same_start & apart).any()
        assert (same_start & apart).any() == (cs >= 8)


def _cameras(v, h, w, depth=1.0):
    """Views looking down +z at a small window from `depth` in front."""
    out = np.zeros((v, 1, 4, 4), np.float32)
    for i in range(v):
        k = np.array([[w * 1.5, 0, (w - 1) / 2], [0, w * 1.5, (h - 1) / 2], [0, 0, 1]])
        out[i, 0] = np.eye(4)
        out[i, 0, :3, :4] = k @ np.array([[1, 0, 0, -0.25 - 0.04 * i],
                                          [0, 1, 0, -0.2], [0, 0, 1, depth]])
    return torch.from_numpy(out)


def _emulate_tiles(dim, interval, origin, voxel_size, proj, count, ct, h, w,
                   plan, seed):
    """The view-tile backward in torch on one thread, partition for
    partition: per view the visible records in a shuffled order (the
    kernel's appends race), per tile and range a private f32 tile summed
    over the range's records, then the cluster merge, each CTA its part of
    the pixels summed in rank order; dT starts as NaN, so an entry no CTA
    writes shows."""
    v, c = proj.shape[0], ct.shape[-1]
    world = bp._window_world(dim, interval, origin.float(), voxel_size, "cpu")
    d_all = ct.reshape(-1, c).float() / count.reshape(-1).clamp(min=1.0)[:, None]
    grad = torch.full((v, h * w, c), float("nan"))
    rng = np.random.default_rng(seed)
    for view in range(v):
        u, vv, m = bp.project_to_view(world, proj[view, 0].float(), h, w)
        rows = torch.from_numpy(rng.permutation(m.nonzero()[:, 0].numpy()))
        iu, iv = torch.floor(u[rows]).long(), torch.floor(vv[rows]).long()
        du, dv = u[rows] - torch.floor(u[rows]), vv[rows] - torch.floor(vv[rows])
        corners = [(iu, iv, (1 - du) * (1 - dv), torch.ones_like(iu, dtype=torch.bool)),
                   (iu + 1, iv, du * (1 - dv), iu + 1 <= w - 1),
                   (iu, iv + 1, (1 - du) * dv, iv + 1 <= h - 1),
                   (iu + 1, iv + 1, du * dv, (iu + 1 <= w - 1) & (iv + 1 <= h - 1))]
        nrec = len(rows)
        part = -(-nrec // plan.ranges)
        for sl in range(c // plan.cs):
            c0 = sl * plan.cs
            tiles = []
            for rank in range(plan.ranges):
                i0 = min(nrec, rank * part)
                i1 = min(nrec, i0 + part)
                tile = torch.zeros(h * w, plan.cs)
                d = d_all[rows[i0:i1], c0:c0 + plan.cs]
                for pu, pv, wq, ok in corners:
                    ok = ok[i0:i1]
                    tile.index_add_(0, (pv * w + pu)[i0:i1][ok],
                                    wq[i0:i1][ok, None] * d[ok])
                tiles.append(tile)
            pp = -(-(h * w) // plan.ranges)
            for rank in range(plan.ranges):
                p0, p1 = min(h * w, rank * pp), min(h * w, (rank + 1) * pp)
                acc = tiles[0][p0:p1]
                for t in tiles[1:]:
                    acc = acc + t[p0:p1]
                grad[view, p0:p1, c0:c0 + plan.cs] = acc
    return grad


@pytest.mark.parametrize("dim,interval,c,cs,ranges", [
    ((10, 12, 9), 1, 24, 8, 3),    # ragged ranges, rows of 3 slices
    ((8, 8, 8), 2, 16, 16, 1),     # one range, no cluster
    ((12, 12, 12), 1, 8, 2, 5),    # 4 slices, 5 ranges
])
def test_tile_partition_emulation_matches_the_plain_backward(dim, interval, c,
                                                             cs, ranges):
    """The view tiles' partition (records in any order, ranges, private
    tiles, the cluster merge) gives window_backward_plain to 1e-5 of its
    largest entry, every entry written."""
    h, w, v = 9, 11, 4
    rng = np.random.default_rng(3)
    origin = torch.tensor([[0.0013, 0.0027, 0.0031]])
    proj = _cameras(v, h, w)
    feats = torch.from_numpy(rng.standard_normal((v, 1, h, w, c)).astype(np.float32))
    count = bp.back_project_window_plain(dim, interval, origin, 0.05, feats, proj)[1]
    ct = torch.from_numpy(rng.standard_normal((*dim, c)).astype(np.float32)).to(torch.bfloat16)
    want = bp.window_backward_plain(dim, interval, origin, 0.05, proj, count, ct, h, w)
    plan = bp.plan_tile(c, h, w, v, cs, ranges)
    assert (count > 0).sum() > 0.3 * count.numel() and (count == 0).any()
    for seed in (0, 1):
        got = _emulate_tiles(dim, interval, origin, 0.05, proj, count, ct, h, w,
                             plan, seed)
        assert not torch.isnan(got).any()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
