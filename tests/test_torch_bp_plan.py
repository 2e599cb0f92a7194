"""The back-projection kernel's launch plan (ops/back_project.py
plan_launch), checked on the CPU at the main path's four call shapes and at
small ones: the bricks tile the voxels, the grid fills the card, and the
shared memory and registers of the CTAs that share an SM fit in it.

The tiling below is the kernel's own index arithmetic (csrc/back_project.cu):
CTA c of a window takes brick (c // (gy*gz), c // gz % gy, c % gz) and slot l
of a brick is voxel (l // (by*bz), l // bz % by, l % bz) of it; CTA c of a
coordinate list takes rows c*run .. c*run + run - 1.
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
    return bp.plan_launch(extent, c, h, w, V, b, mode)


def _rows_of_every_cta(extent, plan):
    """Output rows each CTA's brick slots map to (-1: past the edge)."""
    bvox = math.prod(plan.brick)
    cta = np.arange(plan.grid)[:, None]
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
    warps_per_partition = 16384 // (bp.REGS_PER_THREAD * 32)
    assert plan.ctas_per_sm * plan.threads // 32 <= 4 * warps_per_partition
    assert plan.patch_bytes % 16 == 0 and plan.patch_bytes >= 0


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
    sizes = bp.smem_regions(V, b, math.prod(plan.brick), plan.patch_bytes)
    starts, total = plan.layout[:-1], plan.layout[-1]
    assert len(starts) == len(sizes) and starts[0] == 0
    assert all(o % 16 == 0 for o in plan.layout)
    ends = (*starts[1:], total)
    for (region, size), start, end in zip(sizes.items(), starts, ends):
        assert end - start >= size, region
    assert total - starts[-1] == 2 * plan.patch_bytes == sizes["patch"]


def test_layout_regions_follow_the_kernels_struct():
    """The kernel takes the offsets in the field order of its Layout."""
    src = (Path(bp.__file__).resolve().parents[1] / "csrc" / "back_project.cu").read_text()
    fields = re.search(r"struct Layout \{\s*long long ([\w, ]+);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == [*bp.smem_regions(1, 1, 1, 0), "total"]


def test_staging_buffer_never_exceeds_a_whole_table():
    extent, c, h, w, b, mode = SMALL["narrow"]
    assert _plan(SMALL["narrow"]).patch_bytes == h * w * c * 2


def test_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="exceed shared memory"):
        bp.plan_launch((8, 8, 8), 8, 4, 4, 4000, 1)
