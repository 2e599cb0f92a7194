"""Multi-view back-projection of image features into voxels.

Port of eprecon_tpu/ops/back_project.py (reference: models/
occupancy_initialization.py:61-261): project every voxel into every view,
sample the view's features bilinearly (grid_sample align_corners=True,
zero padding), drop out-of-frustum views, reduce across views.

Two public functions, each with a plain PyTorch version and a CUDA kernel
(csrc/back_project.cu), forward and backward:
  * back_project_window   — mean over visible views on a dense window
  * back_project_variance — cross-view variance on a coordinate list
and two plain helpers on a coordinate list, off the model's path (the
JAX package computes them with XLA): `project_to_views` and
`back_project_mean`.

Both are torch custom ops (`eprecon_tpu_torch::window_mean`, `::variance`,
registered when this module is imported) whose backward ops give the
features' gradient (the counterpart of the JAX package's gather
adjoints), so a tracer records them and an exported program runs them. A
tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises. The plain forward does the kernel's arithmetic in the
kernel's order (f32 sums over bf16 tables, f32 projection without fused
multiply-adds), so on the card the two agree bit for bit; the backwards
scatter with f32 atomics (kernel) or index_add_ (plain) and agree to f32
rounding. The JAX version sums bf16 terms in bf16 and accumulates its
gradient in bf16; the port keeps both in f32 and rounds once.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from eprecon_tpu_torch import kernels
from eprecon_tpu_torch.ops.grid import dense_coords

WINDOW_MEAN, VARIANCE = 0, 1

# kernel launches by (mode, voxels, channels), forward and backward; read
# by the chip smoke run
launch_counts: collections.Counter = collections.Counter()
backward_launch_counts: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def project_to_view(world: torch.Tensor, pm: torch.Tensor, h: int, w: int):
    """world [N, 3] f32; pm [4, 4] or [N, 4, 4] world->pixel.
    Returns (u, v, in-frustum mask), the test of back_project.py:181-186."""
    x, y, z = world.unbind(-1)

    def row(r):
        return ((pm[..., r, 0] * x + pm[..., r, 1] * y)
                + pm[..., r, 2] * z) + pm[..., r, 3]

    cx, cy, cz = row(0), row(1), row(2)
    sz = torch.where(cz.abs() < 1e-12, torch.full_like(cz, 1e-12), cz)
    u = cx / sz
    v = cy / sz
    m = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (cz > 0)
    return u, v, m


def bilinear_sample_flat(table: torch.Tensor, row_offset, u: torch.Tensor,
                         v: torch.Tensor, m: torch.Tensor, h: int, w: int
                         ) -> torch.Tensor:
    """Bilinear sample of a flattened [B*H*W, C] table at pixel coords
    (u, v) (align_corners=True: integer coords hit pixel centres), zero
    outside the image and where `m` is False. row_offset: image start row
    per sample (b * H * W) or 0. Returns [N, C] f32."""
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    iu = torch.where(m, u0, 0).long()
    iv = torch.where(m, v0, 0).long()
    total = None
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        pu, pv = iu + cx, iv + cy
        wgt = (du if cx else 1 - du) * (dv if cy else 1 - dv)
        wgt = torch.where((pu <= w - 1) & (pv <= h - 1), wgt, 0.0)
        idx = row_offset + pv.clamp(max=h - 1) * w + pu.clamp(max=w - 1)
        term = wgt[:, None] * table[idx].float()
        total = term if total is None else total + term
    return torch.where(m[:, None], total, 0.0)


def scatter_corners(grad_table: torch.Tensor, row_offset, u: torch.Tensor,
                    v: torch.Tensor, m: torch.Tensor, d: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """The adjoint of `bilinear_sample_flat` for the table: add each
    sample's cotangent d [N, C], times its 4 corner weights, to the corner
    rows of grad_table [B*H*W, C] f32, in place."""
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    iu = torch.where(m, u0, 0).long()
    iv = torch.where(m, v0, 0).long()
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        pu, pv = iu + cx, iv + cy
        wgt = (du if cx else 1 - du) * (dv if cy else 1 - dv)
        wgt = torch.where((pu <= w - 1) & (pv <= h - 1) & m, wgt, 0.0)
        idx = row_offset + pv.clamp(max=h - 1) * w + pu.clamp(max=w - 1)
        grad_table.index_add_(0, idx, wgt[:, None] * d)
    return grad_table


def _window_world(dim, interval, origin, voxel_size, device):
    coords = dense_coords(dim, device).reshape(-1, 3).float() * interval
    return coords * voxel_size + origin.reshape(-1, 3)[0]


def back_project_window_plain(dim, interval, origin, voxel_size, feats, proj,
                              table_dtype: torch.dtype = torch.bfloat16):
    """The plain window mean. The kernel's table is bf16; `table_dtype`
    f32 gives the same function on an f32 table (for gradient checks)."""
    vv, _, h, w, c = feats.shape
    world = _window_world(dim, interval, origin.float(), voxel_size,
                          feats.device)
    table = feats[:, 0].reshape(vv, h * w, c).to(table_dtype)
    total = torch.zeros(world.shape[0], c, device=feats.device)
    count = torch.zeros(world.shape[0], device=feats.device)
    for vi in range(vv):
        u, v, m = project_to_view(world, proj[vi, 0].float(), h, w)
        total = total + bilinear_sample_flat(table[vi], 0, u, v, m, h, w)
        count = count + m.float()
    mean = total / count.clamp(min=1.0)[:, None]
    return mean.to(table_dtype).reshape(*dim, c), count.reshape(dim)


def window_backward_plain(dim, interval, origin, voxel_size, proj, count, ct,
                          h: int, w: int) -> torch.Tensor:
    """Gradient of the window mean for its [V, H*W, C] table, f32, given
    the mean's cotangent ct [X, Y, Z, C] and the forward's view count."""
    vv, c = proj.shape[0], ct.shape[-1]
    world = _window_world(dim, interval, origin.float(), voxel_size, ct.device)
    d = ct.reshape(-1, c).float() / count.reshape(-1, 1).clamp(min=1.0)
    grad = torch.zeros(vv, h * w, c, device=ct.device)
    for vi in range(vv):
        u, v, m = project_to_view(world, proj[vi, 0].float(), h, w)
        scatter_corners(grad[vi], 0, u, v, m, d, h, w)
    return grad


def project_to_views(coords: torch.Tensor, valid: torch.Tensor,
                     origin: torch.Tensor, voxel_size: float,
                     proj: torch.Tensor, h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project a coordinate list into every view: coords int [K, 4]
    (b, x, y, z) in voxels, valid bool [K], origin [B, 3], proj
    [V, B, 4, 4] world->pixel. Returns (uv [V, K, 2], mask [V, K]: in the
    frustum and valid; reference occupancy_initialization.py:87-102)."""
    b = coords[:, 0].long()
    world = coords[:, 1:].float() * voxel_size + origin.float()[b]
    uv, mask = [], []
    for vi in range(proj.shape[0]):
        u, v, m = project_to_view(world, proj[vi].float()[b], h, w)
        uv.append(torch.stack([u, v], dim=-1))
        mask.append(m & valid)
    return torch.stack(uv), torch.stack(mask)


def _variance_views(coords, valid, origin, voxel_size, feats, proj):
    """Per view: (u, v, visible mask, bilinear sample [K, C] f32), with the
    table rows' batch offsets; shared by the variance, its backward and
    the coordinate-list mean."""
    vv, bb, h, w, c = feats.shape
    uv, mask = project_to_views(coords, valid, origin, voxel_size, proj, h, w)
    table = feats.reshape(vv, bb * h * w, c)
    row_offset = coords[:, 0].long() * (h * w)
    for vi in range(vv):
        u, v = uv[vi].unbind(-1)
        yield u, v, mask[vi], bilinear_sample_flat(
            table[vi], row_offset, u, v, mask[vi], h, w), row_offset


def _variance_sums(coords, valid, origin, voxel_size, feats, proj):
    c = feats.shape[-1]
    s1 = torch.zeros(coords.shape[0], c, device=feats.device)
    s2 = torch.zeros_like(s1)
    count = torch.zeros(coords.shape[0], device=feats.device)
    for _, _, m, s, _ in _variance_views(coords, valid, origin, voxel_size,
                                         feats, proj):
        s1 = s1 + s
        s2 = s2 + s * s
        count = count + m.float()
    return s1, s2, count


def back_project_mean(coords: torch.Tensor, valid: torch.Tensor,
                      origin: torch.Tensor, voxel_size: float,
                      feats: torch.Tensor, proj: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of the visible views' bilinear samples per voxel of a
    coordinate list (reference Back_Project, occupancy_initialization.py:
    189-261): feats [V, B, H, W, C] -> (mean [K, C] in feats' dtype,
    visible views [K] f32)."""
    total = torch.zeros(coords.shape[0], feats.shape[-1], device=feats.device)
    count = torch.zeros(coords.shape[0], device=feats.device)
    for _, _, m, s, _ in _variance_views(coords, valid, origin, voxel_size,
                                         feats, proj):
        total = total + s
        count = count + m.float()
    return (total / count.clamp(min=1.0)[:, None]).to(feats.dtype), count


def back_project_variance_plain(coords, valid, origin, voxel_size, feats, proj):
    s1, s2, count = _variance_sums(coords, valid, origin, voxel_size, feats,
                                   proj)
    denom = count.clamp(min=1.0)[:, None]
    mean = s1 / denom
    var = (s2 / denom - mean * mean).clamp(min=0.0)
    return var.to(feats.dtype), count


def variance_backward_plain(coords, valid, origin, voxel_size, feats, proj,
                            count, ct) -> torch.Tensor:
    """Gradient of the variance for its [V, B*H*W, C] table, f32, given
    the variance's cotangent ct [K, C] and the forward's view count:
    ds_v = g * 2 (s_v - mean) / n per visible sample, g = ct where
    s2/n - mean^2 >= 0 (the gradient of torch's clamp) and 0 elsewhere,
    scattered through the sample's corner weights."""
    vv, bb, h, w, c = feats.shape
    s1, s2, _ = _variance_sums(coords, valid, origin, voxel_size, feats, proj)
    denom = count.clamp(min=1.0)[:, None]
    mean = s1 / denom
    g = torch.where(s2 / denom - mean * mean >= 0, 2 * ct.float() / denom, 0.0)
    grad = torch.zeros(vv, bb * h * w, c, device=feats.device)
    for vi, (u, v, m, s, row_offset) in enumerate(_variance_views(
            coords, valid, origin, voxel_size, feats, proj)):
        scatter_corners(grad[vi], row_offset, u, v, m, g * (s - mean), h, w)
    return grad


# ---------------------------------------------------------------------------
# launch plan (pure arithmetic; the kernel takes its shared-memory layout)
# ---------------------------------------------------------------------------

SM_COUNT = 132                    # H100 SXM
MIN_WAVES = 2                     # full waves of resident CTAs a grid should fill
MAX_THREADS = 256
MAX_CTAS_PER_SM = 32
MAX_THREADS_PER_SM = 2048
SMEM_PER_SM = 228 * 1024          # 1 KB of it reserved per resident CTA
SMEM_GRANULE = 128                # a CTA's shared memory is allocated in these
REGS_PER_SM = 65536               # in 4 sub-partitions, each holding whole warps
# Registers per thread of each kernel instance, as ptxas reports them for
# sm_90a (chip_smoke.py prints the report and fails where the card then
# holds another number of CTAs than a plan assumes); multiples of 8, the
# allocation unit. The forward by (mode, items): its launch bounds (256
# threads x 3 CTAs) cap them at 80. The brick backward: 256 x 4 caps it at
# 64. The per-voxel backward by mode.
REGS_PER_THREAD = {(WINDOW_MEAN, 1): 64, (WINDOW_MEAN, 2): 72,
                   (WINDOW_MEAN, 3): 80, (VARIANCE, 1): 64, (VARIANCE, 2): 80}
BWD_REGS_PER_THREAD = 64
PER_VOXEL_REGS_PER_THREAD = {WINDOW_MEAN: 40, VARIANCE: 64}
SMEM_MAX = 232448                 # the most one CTA can opt in to (227 KB)
MIN_BRICK = 16                    # voxels; smaller only when channels force it
BRICKS = ((8, 8, 8), (4, 8, 8), (4, 4, 8), (4, 4, 4), (2, 4, 4), (2, 2, 4),
          (2, 2, 2), (1, 2, 2), (1, 1, 2), (1, 1, 1))
RUNS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
MAX_ITEMS = {WINDOW_MEAN: 3, VARIANCE: 2}  # forward: f32 sums kept in registers
BWD_MAX_ITEMS = 2                 # brick backward: the window mean's d per item
BOX_MIN_PX = 1024                 # pixels of the largest box the backward should sum
BOX_MAX_PX = 65535                # the kernel packs a box pixel into 16 bits


def _warps_by_regs(regs_per_thread: int) -> int:
    """Warps per SM the registers hold: 4 sub-partitions of whole warps
    (`occupancy` checks it on the card)."""
    return 4 * (REGS_PER_SM // 4 // (regs_per_thread * 32))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    brick: Tuple[int, int, int]  # voxels per CTA; a row run is (run, 1, 1)
    grid: int                    # CTAs
    threads: int                 # per CTA, a multiple of 32
    items: int                   # (voxel, 8-channel) items per thread
    ctas_per_sm: int             # resident CTAs per SM the plan assumes
    layout: Tuple[int, ...]      # shared-memory region offsets, then the total

    @property
    def smem_bytes(self) -> int:  # dynamic shared memory per CTA
        return self.layout[-1] if self.layout else 0


@dataclasses.dataclass(frozen=True)
class BackwardPlan(LaunchPlan):
    """A backward launch: one CTA per (brick, channel split), or per
    MAX_THREADS (voxel, vector) items."""
    cvec: int = 1                # 8-channel vectors per CTA (a divisor of C/8)
    box_px: int = 0              # pixels of the largest box summed in shared memory
    per_voxel: bool = False      # one thread per (voxel, vector), no bricks


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_regions(v: int, b: int, bvox: int):
    """Bytes of each shared-memory region of one forward CTA, in the order
    of `Layout` in csrc/back_project.cu, which says how the kernel indexes
    them."""
    return dict(proj=v * b * 16 * 4, world=bvox * 16, row=bvox * 4,
                cnt=bvox * 4, w=2 * bvox * 16, uv=2 * bvox * 4,
                part=(MAX_THREADS // 32) * 8 * 4, views=(v + 1) * 4)


def backward_regions(v: int, bvox: int, cvec: int, box_px: int):
    """Bytes of each shared-memory region of one brick backward CTA (one
    batch element, a record slot per view), in the order of `BwdLayout` in
    csrc/back_project.cu."""
    return dict(proj=v * 16 * 4, world=bvox * 16, row=bvox * 4,
                w=v * bvox * 16, uv=v * bvox * 4,
                part=(MAX_THREADS // 32) * 8 * 4, box=v * 4 * 4,
                views=(v + 1) * 4, d=bvox * cvec * 8 * 4, list=4 * bvox * 4,
                cnt=(box_px + 1) * 4)


def _layout(regions) -> Tuple[int, ...]:
    """Offsets of the regions, each 16-byte aligned, and their total: the
    layout a kernel is launched with."""
    offsets, at = [], 0
    for size in regions.values():
        offsets.append(at)
        at += _align16(size)
    return (*offsets, at)


def _resident(threads: int, regs: int) -> int:
    """CTAs of `threads` threads at `regs` registers each that one SM holds,
    shared memory aside."""
    return min(_warps_by_regs(regs) // (threads // 32), MAX_CTAS_PER_SM,
               MAX_THREADS_PER_SM // threads)


def _brick_shape(bvox: int, nvec: int, grid: int,
                 regs: Callable[[int], int]) -> Tuple[int, int, int]:
    """(items per thread, threads, resident CTAs per SM) of a brick whose
    CTAs own `nvec` 8-channel vectors of each voxel; `regs` gives the
    registers per thread of the instance for a number of items."""
    items = math.ceil(bvox * nvec / MAX_THREADS)
    threads = 32 * math.ceil(bvox * nvec / items / 32)
    ctas = min(_resident(threads, regs(items)), math.ceil(grid / SM_COUNT))
    return items, threads, max(1, ctas)


def _grid(extent: Tuple[int, ...], brick: Tuple[int, int, int]) -> int:
    return math.prod(math.ceil(e / s) for e, s in zip(extent, brick))


def _choices(extent: Tuple[int, ...], nvec: int, max_items: int
             ) -> List[Tuple[int, int, int]]:
    cands = BRICKS if len(extent) == 3 else tuple((r, 1, 1) for r in RUNS)
    fitting = [br for br in cands
               if math.ceil(math.prod(br) * nvec / MAX_THREADS) <= max_items]
    if not fitting:
        raise ValueError(f"{8 * nvec} channels are too wide for one CTA")
    return [br for br in fitting if math.prod(br) >= MIN_BRICK] or fitting[:1]


def brick_choices(extent: Tuple[int, ...], c: int, mode: int
                  ) -> List[Tuple[int, int, int]]:
    """The bricks a forward launch over `extent` may take, largest first:
    those whose items fit the registers, of at least MIN_BRICK voxels
    (unless the channels leave only smaller ones). extent: (X, Y, Z) of a
    dense window, or (N,) rows of a coordinate list."""
    return _choices(extent, c // 8, MAX_ITEMS[mode])


def _largest_filling(extent, choices, nsplit: int, nvec: int,
                     regs: Callable[[int], int]):
    """The largest brick whose grid fills the card with MIN_WAVES waves of
    resident CTAs, else the one that fills the most. (Per-brick setup and
    view cull favour large bricks; a grid of less than two waves leaves SMs
    idle at its end.)"""
    def waves(br):
        grid = _grid(extent, br) * nsplit
        return grid / (_brick_shape(math.prod(br), nvec, grid, regs)[2] * SM_COUNT)

    full = [br for br in choices if waves(br) >= MIN_WAVES]
    return full[0] if full else max(choices, key=waves)


def _forward_regs(mode: int) -> Callable[[int], int]:
    return lambda items: REGS_PER_THREAD[mode, items]


def plan_brick(extent: Tuple[int, ...], c: int, v: int, b: int,
               brick: Tuple[int, int, int], mode: int = WINDOW_MEAN
               ) -> LaunchPlan:
    """The forward launch over `extent` with one CTA per `brick`; as many
    CTAs share an SM as the registers of the mode's instance allow, or as
    the grid needs to run in one wave if that is fewer."""
    bvox, grid = math.prod(brick), _grid(extent, brick)
    items, threads, ctas = _brick_shape(bvox, c // 8, grid, _forward_regs(mode))
    layout = _layout(smem_regions(v, b, bvox))
    if layout[-1] > SMEM_MAX:
        raise ValueError(f"{v} views x {b} batches exceed shared memory")
    return LaunchPlan(brick, grid, threads, items, ctas, layout)


@functools.lru_cache(maxsize=None)
def plan_launch(extent: Tuple[int, ...], c: int, v: int, b: int = 1,
                mode: int = WINDOW_MEAN) -> LaunchPlan:
    """Brick, grid and shared memory of one forward launch (`plan_brick`):
    the largest of the `brick_choices` that fills the card
    (`_largest_filling`)."""
    brick = _largest_filling(extent, brick_choices(extent, c, mode), 1, c // 8,
                             _forward_regs(mode))
    return plan_brick(extent, c, v, b, brick, mode)


def backward_brick_choices(extent: Tuple[int, int, int], cvec: int, v: int
                           ) -> List[Tuple[int, int, int]]:
    """The bricks a window mean's backward whose CTAs own `cvec` vectors
    may take, largest first: as `brick_choices`, but only those whose
    records for every one of `v` views fit one CTA's shared memory, and of
    those only the ones that fill a CTA of MAX_THREADS threads where any
    does, so that few CTAs share an SM and each keeps a large share of its
    shared memory for the box."""
    fitting = [br for br in _choices(extent, cvec, BWD_MAX_ITEMS)
               if _layout(backward_regions(v, math.prod(br), cvec, 0))[-1] <= SMEM_MAX]
    full = [br for br in fitting if math.prod(br) * cvec >= MAX_THREADS]
    return full or fitting


def plan_backward_brick(extent: Tuple[int, int, int], c: int, h: int, w: int,
                        v: int, brick: Tuple[int, int, int], cvec: int,
                        box_px: Optional[int] = None) -> BackwardPlan:
    """The window mean's brick backward over `extent` with one CTA per
    `brick` and `cvec` of the c/8 vectors. Every view gets a record slot;
    as many CTAs share an SM as the registers allow (or the grid needs) and
    the records leave room for; the per-pixel counts of the box take the
    shared memory those CTAs leave (whole 128-byte granules), capped at a
    whole image (h * w pixels) and BOX_MAX_PX; that cut also makes shared
    memory hold exactly that many CTAs. `box_px` overrides the box (0:
    every brick-view scatters straight into the gradient). Refuses a brick
    whose records for every view do not fit one CTA."""
    nvec = c // 8
    if cvec < 1 or nvec % cvec:
        raise ValueError(f"{cvec} vectors per CTA do not divide {nvec}")
    bvox, grid = math.prod(brick), _grid(extent, brick) * (nvec // cvec)
    items, threads, ctas = _brick_shape(bvox, cvec, grid,
                                        lambda _: BWD_REGS_PER_THREAD)
    if items > BWD_MAX_ITEMS:
        raise ValueError(f"brick {brick} x {cvec} vectors: {items} items per thread")
    fixed = _layout(backward_regions(v, bvox, cvec, 0))[-1]
    if fixed > SMEM_MAX:
        raise ValueError(f"{v} views exceed shared memory")
    ctas = min(ctas, SMEM_PER_SM // (-(-fixed // SMEM_GRANULE) * SMEM_GRANULE + 1024))
    budget = min(SMEM_PER_SM // ctas - 1024, SMEM_MAX) // SMEM_GRANULE * SMEM_GRANULE
    if box_px is None:
        box_px = max(0, min((budget - fixed) // 16 * 4, h * w, BOX_MAX_PX))
    return BackwardPlan(brick, grid, threads, items, ctas,
                        _layout(backward_regions(v, bvox, cvec, box_px)),
                        cvec=cvec, box_px=box_px)


def per_voxel_plan(n: int, c: int, mode: int) -> BackwardPlan:
    """The backward as one thread per (voxel, vector) over n rows: no
    bricks, no shared memory; as many CTAs share an SM as the registers of
    the mode's instance allow."""
    return BackwardPlan((1, 1, 1), math.ceil(n * (c // 8) / MAX_THREADS),
                        MAX_THREADS, 1,
                        _resident(MAX_THREADS, PER_VOXEL_REGS_PER_THREAD[mode]),
                        (), per_voxel=True)


@functools.lru_cache(maxsize=None)
def plan_backward(extent: Tuple[int, ...], c: int, h: int, w: int, v: int,
                  mode: int = WINDOW_MEAN) -> BackwardPlan:
    """The backward launch. The window mean takes bricks: the widest
    channel split (most vectors per CTA) whose box holds BOX_MIN_PX pixels
    (or a whole image); for it, the largest of the `backward_brick_choices`
    that fills the card. (Fewer splits repeat the setup, cull and
    projection fewer times; a larger box keeps more brick-views off the
    direct path.) The variance over its coordinate list, a window where no
    split leaves such a box (or none holds the records of every view), and
    a window whose bricks cannot fill
    MIN_WAVES waves of the card take `per_voxel_plan`: the occupancy init's
    row runs are thin slabs whose corners seldom share a pixel (1.2-1.6
    corners per pixel and run, against 3-5 in a window's bricks), and a
    grid of bricks under two waves is bound by one CTA's chain of phases;
    at both the per-voxel kernel measured faster (PERF.md)."""
    n = math.prod(extent)
    if mode == VARIANCE:
        return per_voxel_plan(n, c, mode)
    nvec = c // 8
    for cvec in sorted((d for d in range(1, nvec + 1) if nvec % d == 0),
                       reverse=True):
        choices = backward_brick_choices(extent, cvec, v)
        if not choices:
            continue
        brick = _largest_filling(extent, choices, nvec // cvec, cvec,
                                 lambda _: BWD_REGS_PER_THREAD)
        plan = plan_backward_brick(extent, c, h, w, v, brick, cvec)
        if plan.box_px >= min(BOX_MIN_PX, h * w):
            break
    else:
        return per_voxel_plan(n, c, mode)
    if plan.grid < MIN_WAVES * plan.ctas_per_sm * SM_COUNT:
        return per_voxel_plan(n, c, mode)
    return plan


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded kernel library."""
    if lib.bp_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bp_forward.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_longlong, i, i, i, i,
                                   ctypes.c_float, i, i, i, i, i, i,
                                   ctypes.POINTER(ctypes.c_longlong),
                                   p, p, p, p]
        lib.bp_forward.restype = ctypes.c_int
        lib.bp_occupancy.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.bp_occupancy.restype = ctypes.c_int
        lib.bp_backward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                    ctypes.c_longlong, i, i, i, i,
                                    ctypes.c_float, i, i, i, i, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_longlong), p, p, p]
        lib.bp_backward.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return bind(kernels.load("back_project"))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _launch(mode: int, table: torch.Tensor, proj: torch.Tensor,
            origin: torch.Tensor, coords: Optional[torch.Tensor],
            valid: Optional[torch.Tensor], n: int, h: int, w: int,
            dims: Sequence[int] = (0, 0, 0), interval: int = 1,
            voxel_size: float = 1.0, stats: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """table [V, B*H*W, C] bf16; proj [V, B, 16] f32; origin [B, 3] f32;
    coords [N, 4] int32 or None (dense window `dims` * `interval`);
    stats: None, or int64 [2] that the kernel adds its brick-view tallies
    to (some voxel visible, none: culled or all out of frustum)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"back-projection kernel needs CUDA tensors, got {dev}")
    vv, rows, c = table.shape
    bb = proj.shape[1]
    if c % 8:
        raise ValueError(f"channels {c} not a multiple of 8")
    if rows != bb * h * w:
        raise ValueError(f"table rows {rows} != B*H*W = {bb * h * w}")
    _check("table", table, torch.bfloat16, (vv, rows, c), dev)
    _check("proj", proj, torch.float32, (vv, bb, 16), dev)
    _check("origin", origin, torch.float32, (bb, 3), dev)
    if coords is not None:
        _check("coords", coords, torch.int32, (n, 4), dev)
        _check("valid", valid, torch.uint8, (n,), dev)
    if stats is not None:
        _check("stats", stats, torch.int64, (2,), dev)
    plan = plan_launch((n,) if coords is not None else tuple(dims), c, vv, bb,
                       mode)
    lib = _library()
    out = torch.empty(n, c, dtype=torch.bfloat16, device=dev)
    count = torch.empty(n, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.bp_forward(ptr(table), ptr(proj), ptr(origin), ptr(coords),
                        ptr(valid), vv, bb, h, w, c, n, dims[0], dims[1],
                        dims[2], interval, float(voxel_size), mode,
                        *plan.brick, plan.threads, plan.items,
                        (ctypes.c_longlong * len(plan.layout))(*plan.layout),
                        out.data_ptr(), count.data_ptr(), ptr(stats),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"back_project kernel launch failed: CUDA error {rc}")
    launch_counts[(mode, n, c)] += 1
    return out, count


def _launch_backward(mode: int, table: Optional[torch.Tensor],
                     proj: torch.Tensor, origin: torch.Tensor,
                     coords: Optional[torch.Tensor],
                     valid: Optional[torch.Tensor], ct: torch.Tensor,
                     count: torch.Tensor, v: int, h: int, w: int,
                     dims: Sequence[int] = (0, 0, 0), interval: int = 1,
                     voxel_size: float = 1.0,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward kernel: the table gradient [V, B*H*W, C] f32 given the
    cotangent ct [N, C] bf16 and the forward's count [N] f32. table: the
    bf16 [V, B*H*W, C] features (variance only; the mean does not read
    them); proj, origin, coords, valid as for `_launch`; stats: None, or
    int64 [3] that a brick plan's kernel (the window mean's) adds its
    brick-view tallies to (summed per pixel in shared memory, scattered
    straight into the gradient, no voxel visible; a per-voxel plan adds
    none)."""
    dev = ct.device
    if dev.type != "cuda":
        raise ValueError(f"back-projection kernel needs CUDA tensors, got {dev}")
    n, c = ct.shape
    bb = proj.shape[1]
    if c % 8:
        raise ValueError(f"channels {c} not a multiple of 8")
    _check("ct", ct, torch.bfloat16, (n, c), dev)
    _check("count", count, torch.float32, (n,), dev)
    _check("proj", proj, torch.float32, (v, bb, 16), dev)
    _check("origin", origin, torch.float32, (bb, 3), dev)
    if mode == VARIANCE:
        _check("table", table, torch.bfloat16, (v, bb * h * w, c), dev)
        _check("coords", coords, torch.int32, (n, 4), dev)
        _check("valid", valid, torch.uint8, (n,), dev)
    if stats is not None:
        _check("stats", stats, torch.int64, (3,), dev)
    plan = plan_backward((n,) if mode == VARIANCE else tuple(dims), c, h, w,
                         v, mode)
    lib = _library()
    grad = torch.zeros(v, bb * h * w, c, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.bp_backward(
        ptr(table), proj.data_ptr(), origin.data_ptr(), ptr(coords),
        ptr(valid), ct.data_ptr(), count.data_ptr(), v, bb, h, w, c, n,
        dims[0], dims[1], dims[2], interval, float(voxel_size), mode,
        int(plan.per_voxel), *plan.brick, plan.cvec, plan.threads, plan.items, (ctypes.c_longlong * len(plan.layout))(*plan.layout),
        grad.data_ptr(), ptr(stats), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"back_project backward launch failed: CUDA error {rc}")
    backward_launch_counts[(mode, n, c)] += 1
    return grad


def total_launches() -> int:
    return sum(launch_counts.values())


def total_backward_launches() -> int:
    return sum(backward_launch_counts.values())


def occupancy(plan: LaunchPlan, mode: int) -> int:
    """CTAs of `plan` (forward, or a BackwardPlan) that one SM of the
    current CUDA device holds, from the CUDA occupancy calculator on the
    built kernel; the plan assumes `plan.ctas_per_sm` of them (from the
    instance's registers; a brick backward's box takes the shared memory
    they leave)."""
    kernel = (0 if not isinstance(plan, BackwardPlan)
              else 2 if plan.per_voxel else 1)
    ctas = ctypes.c_int(0)
    rc = _library().bp_occupancy(kernel, mode, plan.items, plan.threads,
                                 plan.smem_bytes, ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"back_project occupancy query failed: CUDA error {rc}")
    return ctas.value


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------

def _route(t: torch.Tensor, stats: Optional[torch.Tensor]) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"back-projection runs on CPU or CUDA, not {t.device}")
    if t.device.type == "cpu" and stats is not None:
        raise ValueError("stats are the CUDA kernel's; the CPU version has none")
    return t.device.type


def back_project_window(dim: Tuple[int, int, int], interval: int,
                        origin: torch.Tensor, voxel_size: float,
                        feats: torch.Tensor, proj: torch.Tensor,
                        stats: Optional[torch.Tensor] = None):
    """Mean of visible-view features for every voxel of a dense window
    (port of back_project.py:147-212), with the gradient for `feats`
    (`eprecon_tpu_torch::window_mean`; the count gets none).

    dim: (X, Y, Z); interval: window stride in fine voxels; origin [1, 3];
    feats [V, 1, H, W, C]; proj [V, 1, 4, 4]; stats: the kernel's
    brick-view tallies (see `_launch`), for the kernel check; that route
    calls the kernel straight, without a gradient.
    Returns (mean [X, Y, Z, C] bf16, count [X, Y, Z] f32).
    """
    _route(feats, stats)
    if stats is not None:
        return _window_mean_cuda(feats, origin, proj, list(dim), interval,
                                 voxel_size, stats)
    return torch.ops.eprecon_tpu_torch.window_mean(
        feats, origin, proj, list(dim), interval, float(voxel_size))


def back_project_variance(coords: torch.Tensor, valid: torch.Tensor,
                          origin: torch.Tensor, voxel_size: float,
                          feats: torch.Tensor, proj: torch.Tensor,
                          stats: Optional[torch.Tensor] = None):
    """Cross-view feature variance over visible views per voxel, the
    occupancy-init matching cost (port of back_project.py:215-249), with
    the gradient for `feats` (`eprecon_tpu_torch::variance`).

    coords [K, 4] (b, x, y, z) fine units; valid [K] bool; origin [B, 3];
    feats [V, B, H, W, C]; proj [V, B, 4, 4]; stats: as for
    `back_project_window`.
    Returns (variance [K, C] in feats' dtype, count [K] f32). The kernel
    takes bf16 features, the dtype of the path.
    """
    _route(feats, stats)
    if stats is not None:
        return _variance_cuda(feats, coords, valid, origin, proj, voxel_size,
                              stats)
    return torch.ops.eprecon_tpu_torch.variance(feats, coords, valid, origin,
                                               proj, float(voxel_size))


# ---------------------------------------------------------------------------
# the kernels as torch custom ops (namespace eprecon_tpu_torch): a tracer
# (torch.export) records them as nodes, and the recorded program dispatches
# them like any op, to the plain version for CPU tensors and to the kernel
# for CUDA ones. The launch plans are computed when the op runs, not when
# it is traced.
# ---------------------------------------------------------------------------

def _window_mean_cuda(feats, origin, proj, dim, interval, voxel_size,
                      stats=None):
    vv, bb, h, w, c = feats.shape
    if bb != 1:
        raise ValueError("back_project_window takes one batch element")
    dim = tuple(dim)
    mean, count = _launch(
        WINDOW_MEAN, feats.reshape(vv, h * w, c).to(torch.bfloat16).contiguous(),
        proj.float().reshape(vv, 1, 16).contiguous(),
        origin.float().reshape(1, 3).contiguous(), None, None, math.prod(dim),
        h, w, dim, interval, voxel_size, stats)
    return mean.reshape(*dim, c), count.reshape(dim)


def _variance_cuda(feats, coords, valid, origin, proj, voxel_size,
                   stats=None):
    vv, bb, h, w, c = feats.shape
    if feats.dtype != torch.bfloat16:
        raise ValueError(f"variance kernel takes bf16 features, got {feats.dtype}")
    return _launch(VARIANCE, feats.reshape(vv, bb * h * w, c).contiguous(),
                   proj.float().reshape(vv, bb, 16).contiguous(),
                   origin.float().reshape(bb, 3).contiguous(),
                   coords.to(torch.int32).contiguous(),
                   valid.to(torch.uint8).contiguous(), coords.shape[0], h, w,
                   voxel_size=voxel_size, stats=stats)


@torch.library.custom_op("eprecon_tpu_torch::window_mean", mutates_args=(),
                         device_types="cpu")
def _window_mean_op(feats: torch.Tensor, origin: torch.Tensor,
                    proj: torch.Tensor, dim: List[int], interval: int,
                    voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return back_project_window_plain(tuple(dim), interval, origin, voxel_size,
                                     feats, proj)


_window_mean_op.register_kernel("cuda")(_window_mean_cuda)


@_window_mean_op.register_fake
def _(feats, origin, proj, dim, interval, voxel_size):
    return (feats.new_empty((*dim, feats.shape[-1]), dtype=torch.bfloat16),
            feats.new_empty(dim, dtype=torch.float32))


@torch.library.custom_op("eprecon_tpu_torch::window_mean_backward",
                         mutates_args=(), device_types="cpu")
def _window_mean_backward_op(ct: torch.Tensor, origin: torch.Tensor,
                             proj: torch.Tensor, count: torch.Tensor,
                             dim: List[int], interval: int, voxel_size: float,
                             h: int, w: int) -> torch.Tensor:
    """The window mean's [V, H*W, C] f32 table gradient."""
    return window_backward_plain(tuple(dim), interval, origin, voxel_size,
                                 proj, count, ct, h, w)


@_window_mean_backward_op.register_kernel("cuda")
def _(ct, origin, proj, count, dim, interval, voxel_size, h, w):
    vv, c = proj.shape[0], ct.shape[-1]
    return _launch_backward(
        WINDOW_MEAN, None, proj.float().reshape(vv, 1, 16).contiguous(),
        origin.float().reshape(1, 3).contiguous(), None, None,
        ct.reshape(-1, c).to(torch.bfloat16).contiguous(), count.reshape(-1),
        vv, h, w, tuple(dim), interval, voxel_size).reshape(vv, h * w, c)


@_window_mean_backward_op.register_fake
def _(ct, origin, proj, count, dim, interval, voxel_size, h, w):
    return ct.new_empty((proj.shape[0], h * w, ct.shape[-1]),
                        dtype=torch.float32)


def _window_mean_setup(ctx, inputs, output):
    feats, origin, proj, dim, interval, voxel_size = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(origin, proj, output[1])
    ctx.args = (dim, interval, voxel_size, feats.shape, feats.dtype)


def _window_mean_grad(ctx, ct, _):
    origin, proj, count = ctx.saved_tensors
    dim, interval, voxel_size, shape, dtype = ctx.args
    grad = torch.ops.eprecon_tpu_torch.window_mean_backward(
        ct, origin, proj, count, dim, interval, voxel_size, shape[2], shape[3])
    return grad.to(dtype).reshape(shape), None, None, None, None, None


_window_mean_op.register_autograd(_window_mean_grad,
                                  setup_context=_window_mean_setup)


@torch.library.custom_op("eprecon_tpu_torch::variance", mutates_args=(),
                         device_types="cpu")
def _variance_op(feats: torch.Tensor, coords: torch.Tensor,
                 valid: torch.Tensor, origin: torch.Tensor, proj: torch.Tensor,
                 voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return back_project_variance_plain(coords, valid, origin, voxel_size,
                                       feats, proj)


_variance_op.register_kernel("cuda")(_variance_cuda)


@_variance_op.register_fake
def _(feats, coords, valid, origin, proj, voxel_size):
    n = coords.shape[0]
    return (feats.new_empty((n, feats.shape[-1])),
            feats.new_empty((n,), dtype=torch.float32))


@torch.library.custom_op("eprecon_tpu_torch::variance_backward",
                         mutates_args=(), device_types="cpu")
def _variance_backward_op(feats: torch.Tensor, coords: torch.Tensor,
                          valid: torch.Tensor, origin: torch.Tensor,
                          proj: torch.Tensor, count: torch.Tensor,
                          ct: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """The variance's [V, B*H*W, C] f32 table gradient."""
    return variance_backward_plain(coords, valid, origin, voxel_size, feats,
                                   proj, count, ct)


@_variance_backward_op.register_kernel("cuda")
def _(feats, coords, valid, origin, proj, count, ct, voxel_size):
    vv, bb, h, w, c = feats.shape
    return _launch_backward(
        VARIANCE, feats.reshape(vv, bb * h * w, c).contiguous(),
        proj.float().reshape(vv, bb, 16).contiguous(),
        origin.float().reshape(bb, 3).contiguous(),
        coords.to(torch.int32).contiguous(), valid.to(torch.uint8).contiguous(),
        ct.to(torch.bfloat16).contiguous(), count, vv, h, w,
        voxel_size=voxel_size)


@_variance_backward_op.register_fake
def _(feats, coords, valid, origin, proj, count, ct, voxel_size):
    vv, bb, h, w, c = feats.shape
    return feats.new_empty((vv, bb * h * w, c), dtype=torch.float32)


def _variance_setup(ctx, inputs, output):
    feats, coords, valid, origin, proj, voxel_size = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(feats, coords, valid, origin, proj, output[1])
    ctx.voxel_size = voxel_size


def _variance_grad(ctx, ct, _):
    feats, coords, valid, origin, proj, count = ctx.saved_tensors
    grad = torch.ops.eprecon_tpu_torch.variance_backward(
        feats, coords, valid, origin, proj, count, ct, ctx.voxel_size)
    return grad.to(feats.dtype).reshape(feats.shape), None, None, None, None, None


_variance_op.register_autograd(_variance_grad, setup_context=_variance_setup)
