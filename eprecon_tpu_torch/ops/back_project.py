"""Multi-view back-projection of image features into voxels.

Port of eprecon_tpu/ops/back_project.py (reference: models/
occupancy_initialization.py:61-261): project every voxel into every view,
sample the view's features bilinearly (grid_sample align_corners=True,
zero padding), drop out-of-frustum views, reduce across views.

Three public functions, each with a plain PyTorch version and a CUDA
kernel (csrc/back_project.cu), forward and backward:
  * back_project_window   — mean over visible views on a dense window
  * back_project_variance — cross-view variance on a coordinate list (the
    JAX package's signature)
  * back_project_variance_window — the same variance over a dense window,
    which the occupancy init's grid is: both directions then take 3-D
    bricks
and two plain helpers on a coordinate list, off the model's path (the
JAX package computes them with XLA): `project_to_views` and
`back_project_mean`.

All three are torch custom ops (`eprecon_tpu_torch::window_mean`,
`::variance`, `::variance_window`, registered when this module is
imported) whose backward ops give the
features' gradient (the counterpart of the JAX package's gather
adjoints), so a tracer records them and an exported program runs them. A
tensor on the CPU takes the plain versions; a CUDA tensor launches the
kernels or raises. Over a coordinate list (`::variance`, any batch
elements and valid rows) both directions take runs of rows; the model
calls `::variance_window`, whose rows form 3-D bricks. The plain forward does the kernel's arithmetic in the
kernel's order (f32 sums over bf16 tables, f32 projection without fused
multiply-adds), so on the card the two agree bit for bit. The backwards
sum in 64-bit fixed point (`fixed_point_exponent`): each term w_q * d is
formed in f32 as the forward's arithmetic forms it, rounded once to an
integer at the scale 2**e, and every later addition is an integer one,
which no order changes; the table is converted to f32 once. So a
backward repeats bit for bit on the card, and the kernels (integer
atomics) and the plain versions (an int64 index_add_) agree bit for bit.
The JAX version sums bf16 terms in bf16 and accumulates its gradient in
bf16; the port keeps both in f32 (the gradient at a resolution of 2**-e)
and rounds once.
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


# ---------------------------------------------------------------------------
# the backward's fixed point
# ---------------------------------------------------------------------------

FIXED_BITS = 62  # N * (a bound of every term) * 2**e <= 2**FIXED_BITS
MAX_EXPONENT = 126  # 2**e and 2**-e both normal f32


def _ceil_log2(n: int) -> int:
    return max(int(n) - 1, 0).bit_length()


def fixed_point_exponent(n: int, max_ct: torch.Tensor,
                         max_table: Optional[torch.Tensor] = None,
                         views: int = 1) -> torch.Tensor:
    """The scale 2**e at which the backward rounds its terms, and whether
    its gradient is NaN: int32 [2] (e, nan), on max_ct's device, with no
    host synchronisation. The kernels compute the same from the same
    maxima (csrc/back_project.cu fixed_point).

    e is formed only from order-free quantities: the maxima max_ct =
    max |ct| and max_table = max |T| over the whole cotangent and table
    (a maximum is exact in any order), their frexp exponents kc and kt
    (|ct| < 2**kc, |T| < 2**kt) and the integer counts n (rows of the
    cotangent) and views, never from a float sum, which another order
    could move across a power of two.

    No overflow. A row adds to a given entry of a view's table at most
    once: its 4 corners are distinct pixels (a corner past the edge adds
    a zero term), each weight <= 1. So an entry sums at most n terms,
    each of magnitude <= B:
      window mean: |w_q d| <= |d| <= max|ct|, d = ct / max(count, 1), so
        B = max|ct| < 2**k with k = kc;
      variance: s_v and the mean are bilinear samples, and a mean of
        them, of table entries, so |g (s_v - mean)| <= 2 max|ct| *
        2 max|T|, B < 2**k with k = kc + kt + 2.
    e = min(FIXED_BITS - ceil(log2 n) - k, MAX_EXPONENT) makes
    n * B * 2**e < 2**62; the f32 rounding of the products and the half
    unit of each term's rounding stay far inside the factor 2 left to
    the int64 limit 2**63. The resolution of an entry is 2**-e: at stage
    2 (n = 884,736, ceil(log2 n) = 20) about max|ct| * 2**-42, and an
    entry of K terms is within K / 2 * 2**-e of their exact sum before
    its one rounding to f32. A term below 2**-(MAX_EXPONENT + 1) (a
    cotangent whose largest entry is under ~2**-85) rounds to 0.

    NaN: a non-finite max_ct or max_table, or (variance) an intermediate
    that could leave the f32 range (2 ct, a sum of views' samples or a
    term of 2**127 or more), makes the whole table NaN. (JAX's gradient
    is NaN only at the entries a non-finite term reaches.) e is then 0.
    """
    kc = torch.frexp(max_ct.float()).exponent
    nan = ~torch.isfinite(max_ct)
    k = kc
    if max_table is not None:
        kt = torch.frexp(max_table.float()).exponent
        k = kc + kt + 2
        nan = (nan | ~torch.isfinite(max_table) | (k > 127) | (kc > 126)
               | (kt + max(_ceil_log2(views), 1) > 127))
    e = (FIXED_BITS - _ceil_log2(n) - k).clamp(-MAX_EXPONENT, MAX_EXPONENT)
    return torch.stack([torch.where(nan, 0, e), nan]).to(torch.int32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as f32, exactly, for an int32 e in [-126, 127]."""
    return torch.bitwise_left_shift(e + 127, 23).view(torch.float32)


def fixed_to_float(acc: torch.Tensor, fixed: torch.Tensor) -> torch.Tensor:
    """The int64 fixed-point table `acc` as f32: one rounding of each
    entry, then times 2**-e (exact), or NaN everywhere where `fixed`
    (fixed_point_exponent) says so."""
    out = acc.to(torch.float32) * _pow2(-fixed[0])
    return out.masked_fill_(fixed[1].bool(), float("nan"))


def scatter_corners(grad_table: torch.Tensor, row_offset, u: torch.Tensor,
                    v: torch.Tensor, m: torch.Tensor, d: torch.Tensor,
                    h: int, w: int, fixed: torch.Tensor) -> torch.Tensor:
    """The adjoint of `bilinear_sample_flat` for the table: add each
    sample's cotangent d [N, C], times its 4 corner weights, to the corner
    rows of grad_table [B*H*W, C] int64, in place, in fixed point: each
    term w_q * d is formed in f32 and rounded once to an integer at the
    scale 2**e (half to even, as the kernels' __float2ll_rn), `fixed`
    from fixed_point_exponent; the integer sums do not depend on their
    order."""
    scale = _pow2(fixed[0])
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
        grad_table.index_add_(0, idx, torch.round(wgt[:, None] * d * scale).long())
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
    the mean's cotangent ct [X, Y, Z, C] and the forward's view count;
    summed in fixed point (`scatter_corners`)."""
    vv, c = proj.shape[0], ct.shape[-1]
    world = _window_world(dim, interval, origin.float(), voxel_size, ct.device)
    ct = ct.reshape(-1, c).float()
    fixed = fixed_point_exponent(ct.shape[0], ct.abs().amax())
    d = ct / count.reshape(-1, 1).clamp(min=1.0)
    grad = torch.zeros(vv, h * w, c, dtype=torch.int64, device=ct.device)
    for vi in range(vv):
        u, v, m = project_to_view(world, proj[vi, 0].float(), h, w)
        scatter_corners(grad[vi], 0, u, v, m, d, h, w, fixed)
    return fixed_to_float(grad, fixed)


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


def _window_rows(dim, interval, device):
    """The coordinate list (b, x, y, z) of a dense window of one batch
    element, in the window's row order, and its valid mask."""
    xyz = dense_coords(dim, device).reshape(-1, 3).to(torch.int32) * interval
    coords = torch.cat([torch.zeros_like(xyz[:, :1]), xyz], 1)
    return coords, torch.ones(coords.shape[0], dtype=torch.bool, device=device)


def back_project_variance_window_plain(dim, interval, origin, voxel_size,
                                       feats, proj):
    """The plain variance over a dense window: `back_project_variance_plain`
    over the window's rows, so the two agree bit for bit."""
    coords, valid = _window_rows(dim, interval, feats.device)
    return back_project_variance_plain(coords, valid, origin, voxel_size,
                                       feats, proj)


def variance_window_backward_plain(dim, interval, origin, voxel_size, feats,
                                   proj, count, ct) -> torch.Tensor:
    """`variance_backward_plain` over a dense window's rows."""
    coords, valid = _window_rows(dim, interval, feats.device)
    return variance_backward_plain(coords, valid, origin, voxel_size, feats,
                                   proj, count, ct)


def variance_backward_plain(coords, valid, origin, voxel_size, feats, proj,
                            count, ct) -> torch.Tensor:
    """Gradient of the variance for its [V, B*H*W, C] table, f32, given
    the variance's cotangent ct [K, C] and the forward's view count:
    ds_v = g * 2 (s_v - mean) / n per visible sample, g = ct where
    s2/n - mean^2 >= 0 (the gradient of torch's clamp) and 0 elsewhere,
    scattered through the sample's corner weights, in fixed point
    (`scatter_corners`)."""
    vv, bb, h, w, c = feats.shape
    s1, s2, _ = _variance_sums(coords, valid, origin, voxel_size, feats, proj)
    fixed = fixed_point_exponent(coords.shape[0], ct.float().abs().amax(),
                                 feats.float().abs().amax(), vv)
    denom = count.clamp(min=1.0)[:, None]
    mean = s1 / denom
    g = torch.where(s2 / denom - mean * mean >= 0, 2 * ct.float() / denom, 0.0)
    grad = torch.zeros(vv, bb * h * w, c, dtype=torch.int64, device=feats.device)
    for vi, (u, v, m, s, row_offset) in enumerate(_variance_views(
            coords, valid, origin, voxel_size, feats, proj)):
        scatter_corners(grad[vi], row_offset, u, v, m, g * (s - mean), h, w,
                        fixed)
    return fixed_to_float(grad, fixed)


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
# threads x 3 CTAs) cap them at 80. The brick backward by mode, one item
# per thread: 256 x 4 caps the window mean's at 64, 256 x 3 the
# variance's at 80. The coordinate list's backward (the variance's runs
# of rows), 256 x 3 too. The window mean's view-tile backward by channels
# per tile: 1024 x 1 caps it at 64; its visible-records pass.
REGS_PER_THREAD = {(WINDOW_MEAN, 1): 64, (WINDOW_MEAN, 2): 72,
                   (WINDOW_MEAN, 3): 80, (VARIANCE, 1): 64, (VARIANCE, 2): 80}
BWD_REGS_PER_THREAD = {WINDOW_MEAN: 64, VARIANCE: 80}
LIST_BWD_REGS_PER_THREAD = 80
TILE_REGS_PER_THREAD = {2: 64, 4: 64, 8: 64, 16: 64}
VISIBLE_REGS_PER_THREAD = 32
SMEM_MAX = 232448                 # the most one CTA can opt in to (227 KB)
MIN_BRICK = 16                    # voxels; smaller only when channels force it
BRICKS = ((8, 8, 8), (4, 8, 8), (4, 4, 8), (4, 4, 4), (2, 4, 4), (2, 2, 4),
          (2, 2, 2), (1, 2, 2), (1, 1, 2), (1, 1, 1))
RUNS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
MAX_ITEMS = {WINDOW_MEAN: 3, VARIANCE: 2}  # forward: f32 sums kept in registers
BOX_MIN_PX = 96                   # brick backward: pixels of its smallest box,
BOX_MAX_PX = {WINDOW_MEAN: 256, VARIANCE: 96}  # and of its largest, by mode
TILE_MAX_THREADS = 1024           # view-tile backward: threads per CTA
MAX_CLUSTER = 8                   # CTAs per view tile (a portable cluster)


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
    """A brick backward launch over a dense window, or over a coordinate
    list's runs of rows (`rows`): one CTA per (brick, channel split), one
    (voxel, vector) item per thread (`items` is 1)."""
    cvec: int = 1                # 8-channel vectors per CTA (a divisor of C/8)
    box_px: int = 0              # pixels of the largest box summed in shared memory
    rows: bool = False           # a coordinate list: runs of rows, no box


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The window mean's view-tile backward: first the visible-records
    pass, one thread per (view, row), MAX_THREADS per CTA;
    then one cluster of `ranges` CTAs per tile (view, `cs` channels). CTA i
    of the grid is rank i % ranges of tile i // ranges; tile t is channels
    (t % (c / cs)) * cs .. + cs - 1 of view t // (c / cs); rank r takes
    places r * ceil(m / ranges) .. of the m visible records of its view."""
    cs: int                      # channels per tile
    ranges: int                  # record ranges per tile = CTAs per cluster
    tiles: int                   # V * C / cs
    threads: int                 # per CTA, a multiple of 32
    ctas_per_sm: int             # resident CTAs per SM the plan assumes
    layout: Tuple[int, ...]      # shared-memory region offsets, then the total
    visible_ctas_per_sm: int     # the visible-records pass's

    @property
    def grid(self) -> int:       # CTAs
        return self.tiles * self.ranges

    @property
    def smem_bytes(self) -> int:
        return self.layout[-1]


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_regions(v: int, b: int, bvox: int):
    """Bytes of each shared-memory region of one forward CTA, in the order
    of `Layout` in csrc/back_project.cu, which says how the kernel indexes
    them."""
    return dict(proj=v * b * 16 * 4, world=bvox * 16, row=bvox * 4,
                cnt=bvox * 4, w=2 * bvox * 16, uv=2 * bvox * 4,
                part=(MAX_THREADS // 32) * 8 * 4, views=(v + 1) * 4)


def backward_regions(v: int, bvox: int, cvec: int, box_px: int, b: int = 1):
    """Bytes of each shared-memory region of one brick backward CTA (the
    projections of `b` batch elements, a record slot per view: corner
    pixel and the fractions (du, dv)), in the order of `BwdLayout` in
    csrc/back_project.cu: the last is the box, box_px pixels x 8 * cvec
    channels of int64 as two planes of 32-bit words, each pixel padded by
    a word (an odd stride spreads a warp's pixels over the banks)."""
    return dict(proj=v * b * 16 * 4, world=bvox * 16, row=bvox * 4,
                w=v * bvox * 8, uv=v * bvox * 4,
                part=(MAX_THREADS // 32) * 8 * 4, box=v * 4 * 4,
                views=(v + 1) * 4, acc=box_px * (cvec * 8 + 1) * 8)


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


def _backward_regs(mode: int, rows: bool = False) -> Callable[[int], int]:
    regs = LIST_BWD_REGS_PER_THREAD if rows else BWD_REGS_PER_THREAD[mode]
    return lambda items: regs


def backward_brick_choices(extent: Tuple[int, ...], cvec: int, v: int,
                           mode: int = WINDOW_MEAN, b: int = 1
                           ) -> List[Tuple[int, int, int]]:
    """The bricks a brick backward whose CTAs own `cvec` vectors may take,
    largest first: as `brick_choices`, at one item per thread, but only
    those whose records for every one of `v` views and a box of BOX_MIN_PX
    pixels (a coordinate list's runs of rows over `b` batch elements: no
    box) fit one CTA's shared memory."""
    box = 0 if len(extent) == 1 else BOX_MIN_PX
    return [br for br in _choices(extent, cvec, 1)
            if _layout(backward_regions(v, math.prod(br), cvec, box,
                                        b))[-1] <= SMEM_MAX]


def plan_backward_brick(extent: Tuple[int, ...], c: int, h: int, w: int,
                        v: int, brick: Tuple[int, int, int], cvec: int,
                        box_px: Optional[int] = None,
                        mode: int = WINDOW_MEAN, b: int = 1) -> BackwardPlan:
    """The brick backward of `mode` over `extent` with one CTA per `brick`
    and `cvec` of the c/8 vectors. Every view gets a record slot. The box
    takes the shared memory that the CTAs the registers allow (or the grid
    needs) leave (whole 128-byte granules), with fewer CTAs where that is
    under BOX_MIN_PX pixels, and holds at most the mode's BOX_MAX_PX or
    h * w pixels: a box is read whole when it is flushed, between two
    barriers, so a larger one costs more than the brick-views it keeps off
    the direct path, which waits at none; the variance's barriers also
    wait for each view's samples (PERF.md). The plan assumes the CTAs per
    SM that registers and the final shared memory allow. `box_px`
    overrides the box (0: every brick-view scatters straight into the
    gradient). A coordinate list (extent (N,), `brick` a run of rows
    (run, 1, 1) of `b` batch elements; the variance only) keeps no box:
    its rows need not be neighbours, so every brick-view scatters straight
    into the gradient. Refuses a brick whose records for every view do not
    fit one CTA."""
    nvec = c // 8
    rows = len(extent) == 1
    if rows and mode != VARIANCE:
        raise ValueError("the window mean's backward takes a dense window, "
                         "not a coordinate list")
    if not rows and b != 1:
        raise ValueError(f"a dense window's backward takes one batch element, "
                         f"not {b}")
    if rows and box_px:
        raise ValueError("a coordinate list's backward keeps no box")
    if cvec < 1 or nvec % cvec:
        raise ValueError(f"{cvec} vectors per CTA do not divide {nvec}")
    bvox, grid = math.prod(brick), _grid(extent, brick) * (nvec // cvec)
    if bvox * cvec > MAX_THREADS:
        raise ValueError(f"brick {brick} x {cvec} vectors: more items than "
                         f"{MAX_THREADS} threads")
    items, threads, by_regs = _brick_shape(bvox, cvec, grid,
                                           _backward_regs(mode, rows))
    fixed = _layout(backward_regions(v, bvox, cvec, 0, b))[-1]
    if fixed > SMEM_MAX:
        raise ValueError(f"{v} views exceed shared memory")
    if rows:
        box_px = 0
    if box_px is None:
        def room(n):  # box pixels that n CTAs per SM leave
            budget = min(SMEM_PER_SM // n - 1024, SMEM_MAX) // SMEM_GRANULE * SMEM_GRANULE
            return max(0, (budget - fixed) // ((cvec * 8 + 1) * 8))

        ctas = by_regs
        while ctas > 1 and room(ctas) < min(BOX_MIN_PX, h * w):
            ctas -= 1
        box_px = min(room(ctas), BOX_MAX_PX[mode], h * w)
    layout = _layout(backward_regions(v, bvox, cvec, box_px, b))
    if layout[-1] > SMEM_MAX:
        raise ValueError(f"a box of {box_px} pixels x {8 * cvec} channels "
                         "exceeds shared memory")
    # the CTAs the registers (or the grid) and the final shared memory allow
    return BackwardPlan(brick, grid, threads, items,
                        max(1, min(by_regs, _smem_ctas(layout[-1]))), layout,
                        cvec=cvec, box_px=box_px, rows=rows)


def tile_regions(h: int, w: int, cs: int):
    """Bytes of each shared-memory region of one view-tile CTA, in the order
    of `TileLayout` in csrc/back_project.cu: the int64 fixed-point gradient
    tile."""
    return dict(tile=h * w * cs * 8)


def _smem_ctas(smem_bytes: int) -> int:
    """CTAs of `smem_bytes` of dynamic shared memory that one SM holds."""
    return SMEM_PER_SM // (-(-smem_bytes // SMEM_GRANULE) * SMEM_GRANULE + 1024)


def tile_channel_choices(c: int, h: int, w: int) -> List[int]:
    """Channels per tile the view-tile backward may take, largest first: the
    instances' slices (csrc/back_project.cu pick_tile) that divide c and
    whose tile fits one CTA's shared memory."""
    return [cs for cs in sorted(TILE_REGS_PER_THREAD, reverse=True)
            if c % cs == 0 and _layout(tile_regions(h, w, cs))[-1] <= SMEM_MAX]


def plan_tile(c: int, h: int, w: int, v: int, cs: int, ranges: int
              ) -> TilePlan:
    """The view-tile backward with `cs` channels per tile and `ranges` CTAs
    per tile: 512 threads per CTA where two CTAs fit an SM's shared memory,
    else 1024; as many CTAs share an SM as shared memory and the instance's
    registers allow."""
    if cs not in tile_channel_choices(c, h, w):
        raise ValueError(f"{cs} channels per tile: no instance, or {h}x{w} "
                         "pixels exceed shared memory")
    if not 1 <= ranges <= MAX_CLUSTER:
        raise ValueError(f"{ranges} ranges: clusters hold 1..{MAX_CLUSTER} CTAs")
    layout = _layout(tile_regions(h, w, cs))
    threads = 512 if _smem_ctas(layout[-1]) >= 2 else TILE_MAX_THREADS
    ctas = min(_smem_ctas(layout[-1]),
               _resident(threads, TILE_REGS_PER_THREAD[cs]))
    return TilePlan(cs, ranges, v * (c // cs), threads, ctas, layout,
                    _resident(MAX_THREADS, VISIBLE_REGS_PER_THREAD))


@functools.lru_cache(maxsize=None)
def view_tile_plan(c: int, h: int, w: int, v: int) -> TilePlan:
    """The window mean's view-tile backward over c channels and v views of
    h x w pixels: of every channel slice (`tile_channel_choices`)
    and every number of ranges (1..MAX_CLUSTER), the plan with the most
    CTAs that still run in one wave of resident CTAs (ctas_per_sm per SM),
    the most channels per tile among equals; where none fits one wave, the
    fewest CTAs. (A second wave waits for the first's slowest tile; within
    one wave more ranges shorten each CTA's list: PERF.md.)"""
    plans = [plan_tile(c, h, w, v, cs, k)
             for cs in tile_channel_choices(c, h, w)
             for k in range(1, MAX_CLUSTER + 1)]
    if not plans:
        raise ValueError(f"{h}x{w} pixels x {c} channels: no view tile fits "
                         "shared memory")
    one_wave = [p for p in plans if p.grid <= p.ctas_per_sm * SM_COUNT]
    if one_wave:
        return max(one_wave, key=lambda p: (p.grid, p.cs))
    return min(plans, key=lambda p: (p.grid, -p.cs))


@functools.lru_cache(maxsize=None)
def plan_backward(extent: Tuple[int, ...], c: int, h: int, w: int, v: int,
                  mode: int = WINDOW_MEAN, b: int = 1):
    """The backward launch over a dense window (extent (X, Y, Z), one batch
    element) or, for the variance, over a coordinate list of `b` batch
    elements (extent (N,): runs of rows, `plan_backward_brick`, by the
    rule below, never view tiles). It takes bricks of
    one (voxel, vector) item per thread: of every
    channel split and brick (`backward_brick_choices`), the one with the
    most threads per CTA, the widest split and then the largest brick
    among equals (more threads share each of a CTA's barriers, and one
    item leaves the registers for more CTAs; fewer splits repeat the
    setup, cull and projection fewer times: PERF.md). Where its grid
    cannot fill MIN_WAVES waves of the card, the window mean takes view
    tiles (`view_tile_plan`) where one fits (a grid of bricks under two
    waves is bound by one CTA's chain of phases: PERF.md), and the
    variance the brick plan that fills the card most."""
    if len(extent) == 1 and mode != VARIANCE:
        raise ValueError("the window mean's backward takes a dense window, "
                         "not a coordinate list")
    nvec = c // 8
    plans = [plan_backward_brick(extent, c, h, w, v, brick, cvec, mode=mode,
                                 b=b)
             for cvec in range(1, nvec + 1) if nvec % cvec == 0
             for brick in backward_brick_choices(extent, cvec, v, mode, b)]
    waves = lambda p: p.grid / (p.ctas_per_sm * SM_COUNT)
    plan = max(plans, key=lambda p: (p.threads, p.cvec, math.prod(p.brick)),
               default=None)
    if plan is None or waves(plan) < MIN_WAVES:
        if mode == WINDOW_MEAN and tile_channel_choices(c, h, w):
            return view_tile_plan(c, h, w, v)
        plan = max(plans, key=waves, default=None)
    if plan is None:
        raise ValueError(f"{v} views, {h}x{w} pixels x {c} channels: neither "
                         "bricks nor a view tile fit shared memory")
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
                                    ctypes.c_float, i, i, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    p, p, p, p, p]
        lib.bp_backward.restype = ctypes.c_int
        lib.bp_backward_tiles.argtypes = [
            p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i, i,
            ctypes.c_float, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
            p, p, p, p, p, p, p]
        lib.bp_backward_tiles.restype = ctypes.c_int
        lib.bp_tile_occupancy.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                          ctypes.POINTER(i)]
        lib.bp_tile_occupancy.restype = ctypes.c_int
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


def launch_key(mode: int, n: int, c: int, rows: bool = False) -> tuple:
    """A launch's key in launch_counts and backward_launch_counts: (mode,
    rows or voxels, channels), with "rows" last for a coordinate list."""
    return (mode, n, c, "rows") if rows else (mode, n, c)


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
    launch_counts[launch_key(mode, n, c, coords is not None)] += 1
    return out, count


def _launch_backward(mode: int, table: Optional[torch.Tensor],
                     proj: torch.Tensor, origin: torch.Tensor,
                     ct: torch.Tensor, count: torch.Tensor, v: int, h: int,
                     w: int, dims: Optional[Sequence[int]], interval: int = 1,
                     voxel_size: float = 1.0,
                     stats: Optional[torch.Tensor] = None,
                     coords: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward kernels: the table gradient [V, B*H*W, C] f32 given the
    cotangent ct [N, C] bf16 and the forward's count [N] f32, summed in
    fixed point (the library first reduces max |ct|, and max |table| for
    the variance, into a scratch it zeroes; a design that adds in device
    memory adds into an int64 scratch and converts it last). table: the
    bf16 [V, B*H*W, C] features (variance only; the mean does not read
    them); proj, origin as for `_launch`, over a dense window `dims` *
    `interval` of one batch element (B = 1) or, the variance only, over
    the coordinate list coords [N, 4] int32 with valid [N] uint8 (dims
    None); stats: None, or int64 [3]
    that the kernel adds its tallies to: a brick plan its brick-views
    (summed per pixel in shared memory, scattered straight into the
    gradient, no voxel visible), a view-tile plan the visible (voxel,
    view) pairs it took, in [0]."""
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
    if coords is None:
        if bb != 1 or math.prod(dims) != n:
            raise ValueError(f"a dense window {tuple(dims)} of one batch "
                             f"element has {math.prod(dims)} rows, got {n} "
                             f"and {bb} batches")
        extent = tuple(dims)
    else:
        _check("coords", coords, torch.int32, (n, 4), dev)
        _check("valid", valid, torch.uint8, (n,), dev)
        extent, dims = (n,), (0, 0, 0)
    if stats is not None:
        _check("stats", stats, torch.int64, (3,), dev)
    plan = plan_backward(extent, c, h, w, v, mode, bb)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # every entry of grad is written by the tiles' merge or the conversion
    # pass, every entry of acc zeroed by the reduction: no fill here
    grad = torch.empty(v, bb * h * w, c, dtype=torch.float32, device=dev)
    maxima = torch.empty(2, dtype=torch.int32, device=dev)
    if isinstance(plan, TilePlan):
        nrec = torch.zeros(v, dtype=torch.int32, device=dev)
        rec_ru = torch.empty(v * n, 2, dtype=torch.int32, device=dev)
        rec_w = torch.empty(v * n, 4, dtype=torch.float32, device=dev)
        rc = lib.bp_backward_tiles(
            proj.data_ptr(), origin.data_ptr(), ct.data_ptr(), count.data_ptr(),
            v, h, w, c, n, dims[1], dims[2], interval, float(voxel_size),
            plan.cs, plan.ranges, plan.threads, plan.ctas_per_sm,
            (ctypes.c_longlong * len(plan.layout))(*plan.layout),
            maxima.data_ptr(), nrec.data_ptr(), rec_ru.data_ptr(),
            rec_w.data_ptr(), grad.data_ptr(), ptr(stats), stream)
    else:
        acc = torch.empty(grad.shape, dtype=torch.int64, device=dev)
        rc = lib.bp_backward(
            proj.data_ptr(), origin.data_ptr(), ptr(coords), ptr(valid),
            ptr(table), ct.data_ptr(), count.data_ptr(), v, bb, h, w, c, n,
            *dims, interval, float(voxel_size), mode, *plan.brick, plan.cvec,
            plan.threads,
            (ctypes.c_longlong * len(plan.layout))(*plan.layout),
            maxima.data_ptr(), acc.data_ptr(), grad.data_ptr(), ptr(stats),
            stream)
    if rc != 0:
        raise RuntimeError(f"back_project backward launch failed: CUDA error {rc}")
    backward_launch_counts[launch_key(mode, n, c, coords is not None)] += 1
    return grad


def total_launches() -> int:
    return sum(launch_counts.values())


def total_backward_launches() -> int:
    return sum(backward_launch_counts.values())


def _occupancy(kernel: int, mode: int, items: int, threads: int,
               smem_bytes: int) -> int:
    ctas = ctypes.c_int(0)
    rc = _library().bp_occupancy(kernel, mode, items, threads, smem_bytes,
                                 ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"back_project occupancy query failed: CUDA error {rc}")
    return ctas.value


def occupancy(plan, mode: int) -> int:
    """CTAs of `plan` (forward, a BackwardPlan or a TilePlan) that one SM of
    the current CUDA device holds, from the CUDA occupancy calculator on the
    built kernel; the plan assumes `plan.ctas_per_sm` of them (from the
    instance's registers and its shared memory; a brick backward's box
    takes the shared memory they leave)."""
    if isinstance(plan, TilePlan):
        return tile_occupancy(plan)[0]
    kernel = ((3 if plan.rows else 1) if isinstance(plan, BackwardPlan)
              else 0)
    return _occupancy(kernel, mode, plan.items, plan.threads, plan.smem_bytes)


def visible_occupancy(plan: TilePlan) -> int:
    """CTAs of the view-tile backward's visible-records pass that one SM
    holds; the plan assumes `plan.visible_ctas_per_sm`."""
    return _occupancy(2, WINDOW_MEAN, 1, MAX_THREADS, 0)


def tile_occupancy(plan: TilePlan) -> Tuple[int, int]:
    """(CTAs per SM, clusters per device) of `plan`'s view-tile kernel that
    the current device holds, with the shared-memory carveout the plan's
    CTAs need (CUDA occupancy calculator, cudaOccupancyMaxActiveClusters)."""
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _library().bp_tile_occupancy(plan.cs, plan.threads, plan.smem_bytes,
                                      plan.ctas_per_sm, plan.ranges,
                                      ctypes.byref(ctas), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"back_project occupancy query failed: CUDA error {rc}")
    return ctas.value, clusters.value


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


def back_project_variance_window(dim: Tuple[int, int, int], interval: int,
                                 origin: torch.Tensor, voxel_size: float,
                                 feats: torch.Tensor, proj: torch.Tensor,
                                 stats: Optional[torch.Tensor] = None):
    """Cross-view feature variance over visible views for every voxel of a
    dense window of one batch element, with the gradient for `feats`
    (`eprecon_tpu_torch::variance_window`): `back_project_variance` over
    the window's rows (x, y, z) * interval, bit for bit, with 3-D bricks
    in both directions on the card.

    dim: (X, Y, Z); interval: window stride in fine voxels; origin [1, 3];
    feats [V, 1, H, W, C] bf16 on the card; proj [V, 1, 4, 4]; stats: as
    for `back_project_window`.
    Returns (variance [X*Y*Z, C] in feats' dtype, count [X*Y*Z] f32).
    """
    _route(feats, stats)
    if stats is not None:
        return _variance_window_cuda(feats, origin, proj, list(dim), interval,
                                     voxel_size, stats)
    return torch.ops.eprecon_tpu_torch.variance_window(
        feats, origin, proj, list(dim), interval, float(voxel_size))


def back_project_variance(coords: torch.Tensor, valid: torch.Tensor,
                          origin: torch.Tensor, voxel_size: float,
                          feats: torch.Tensor, proj: torch.Tensor,
                          stats: Optional[torch.Tensor] = None):
    """Cross-view feature variance over visible views per voxel, the
    occupancy-init matching cost (port of back_project.py:215-249), with
    the gradient for `feats` (`eprecon_tpu_torch::variance`): on the card
    both directions run their kernels over runs of rows (the model's
    dense grid takes `back_project_variance_window`, whose rows form 3-D
    bricks).

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


def _variance_window_cuda(feats, origin, proj, dim, interval, voxel_size,
                          stats=None):
    vv, bb, h, w, c = feats.shape
    if bb != 1:
        raise ValueError("back_project_variance_window takes one batch element")
    if feats.dtype != torch.bfloat16:
        raise ValueError(f"variance kernel takes bf16 features, got {feats.dtype}")
    dim = tuple(dim)
    return _launch(VARIANCE, feats.reshape(vv, h * w, c).contiguous(),
                   proj.float().reshape(vv, 1, 16).contiguous(),
                   origin.float().reshape(1, 3).contiguous(), None, None,
                   math.prod(dim), h, w, dim, interval, voxel_size, stats)


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
        origin.float().reshape(1, 3).contiguous(),
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
    if feats.dtype != torch.bfloat16:
        raise ValueError(f"variance kernel takes bf16 features, got {feats.dtype}")
    return _launch_backward(
        VARIANCE, feats.reshape(vv, bb * h * w, c).contiguous(),
        proj.float().reshape(vv, bb, 16).contiguous(),
        origin.float().reshape(bb, 3).contiguous(),
        ct.to(torch.bfloat16).contiguous(), count.contiguous(), vv, h, w, None,
        voxel_size=voxel_size, coords=coords.to(torch.int32).contiguous(),
        valid=valid.to(torch.uint8).contiguous())


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


@torch.library.custom_op("eprecon_tpu_torch::variance_window",
                         mutates_args=(), device_types="cpu")
def _variance_window_op(feats: torch.Tensor, origin: torch.Tensor,
                        proj: torch.Tensor, dim: List[int], interval: int,
                        voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return back_project_variance_window_plain(tuple(dim), interval, origin,
                                              voxel_size, feats, proj)


_variance_window_op.register_kernel("cuda")(_variance_window_cuda)


@_variance_window_op.register_fake
def _(feats, origin, proj, dim, interval, voxel_size):
    n = math.prod(dim)
    return (feats.new_empty((n, feats.shape[-1])),
            feats.new_empty((n,), dtype=torch.float32))


@torch.library.custom_op("eprecon_tpu_torch::variance_window_backward",
                         mutates_args=(), device_types="cpu")
def _variance_window_backward_op(feats: torch.Tensor, origin: torch.Tensor,
                                 proj: torch.Tensor, count: torch.Tensor,
                                 ct: torch.Tensor, dim: List[int],
                                 interval: int, voxel_size: float
                                 ) -> torch.Tensor:
    """The window variance's [V, H*W, C] f32 table gradient."""
    return variance_window_backward_plain(tuple(dim), interval, origin,
                                          voxel_size, feats, proj, count, ct)


@_variance_window_backward_op.register_kernel("cuda")
def _(feats, origin, proj, count, ct, dim, interval, voxel_size):
    vv, bb, h, w, c = feats.shape
    return _launch_backward(
        VARIANCE, feats.reshape(vv, h * w, c).contiguous(),
        proj.float().reshape(vv, 1, 16).contiguous(),
        origin.float().reshape(1, 3).contiguous(),
        ct.to(torch.bfloat16).contiguous(), count, vv, h, w, tuple(dim),
        interval, voxel_size)


@_variance_window_backward_op.register_fake
def _(feats, origin, proj, count, ct, dim, interval, voxel_size):
    vv, bb, h, w, c = feats.shape
    return feats.new_empty((vv, bb * h * w, c), dtype=torch.float32)


def _variance_window_setup(ctx, inputs, output):
    feats, origin, proj, dim, interval, voxel_size = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(feats, origin, proj, output[1])
    ctx.args = (dim, interval, voxel_size)


def _variance_window_grad(ctx, ct, _):
    feats, origin, proj, count = ctx.saved_tensors
    dim, interval, voxel_size = ctx.args
    grad = torch.ops.eprecon_tpu_torch.variance_window_backward(
        feats, origin, proj, count, ct, dim, interval, voxel_size)
    return grad.to(feats.dtype).reshape(feats.shape), None, None, None, None, None


_variance_window_op.register_autograd(_variance_window_grad,
                                      setup_context=_variance_window_setup)
