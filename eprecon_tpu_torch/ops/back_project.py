"""Multi-view back-projection of image features into voxels.

Port of eprecon_tpu/ops/back_project.py (reference: models/
occupancy_initialization.py:61-261): project every voxel into every view,
sample the view's features bilinearly (grid_sample align_corners=True,
zero padding), drop out-of-frustum views, reduce across views.

Two public functions, each with a plain PyTorch version and a CUDA kernel
(csrc/back_project.cu):
  * back_project_window   — mean over visible views on a dense window
  * back_project_variance — cross-view variance on a coordinate list

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. The plain version does the kernel's arithmetic in the
kernel's order (f32 sums over bf16 tables, f32 projection without fused
multiply-adds), so on the card the two agree bit for bit. The JAX version
sums bf16 terms in bf16; the port keeps the sums in f32 and rounds once.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from eprecon_tpu_torch import kernels
from eprecon_tpu_torch.ops.grid import dense_coords

WINDOW_MEAN, VARIANCE = 0, 1

# kernel launches by (mode, voxels, channels); read by the chip smoke run
launch_counts: collections.Counter = collections.Counter()


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


def _window_world(dim, interval, origin, voxel_size, device):
    coords = dense_coords(dim, device).reshape(-1, 3).float() * interval
    return coords * voxel_size + origin[0]


def back_project_window_plain(dim, interval, origin, voxel_size, feats, proj):
    vv, _, h, w, c = feats.shape
    world = _window_world(dim, interval, origin.float(), voxel_size,
                          feats.device)
    table = feats[:, 0].reshape(vv, h * w, c).to(torch.bfloat16)
    total = torch.zeros(world.shape[0], c, device=feats.device)
    count = torch.zeros(world.shape[0], device=feats.device)
    for vi in range(vv):
        u, v, m = project_to_view(world, proj[vi, 0].float(), h, w)
        total = total + bilinear_sample_flat(table[vi], 0, u, v, m, h, w)
        count = count + m.float()
    mean = total / count.clamp(min=1.0)[:, None]
    return mean.to(torch.bfloat16).reshape(*dim, c), count.reshape(dim)


def back_project_variance_plain(coords, valid, origin, voxel_size, feats, proj):
    vv, bb, h, w, c = feats.shape
    b = coords[:, 0].long()
    world = coords[:, 1:].float() * voxel_size + origin.float()[b]
    table = feats.reshape(vv, bb * h * w, c)
    row_offset = b * (h * w)
    s1 = torch.zeros(coords.shape[0], c, device=feats.device)
    s2 = torch.zeros_like(s1)
    count = torch.zeros(coords.shape[0], device=feats.device)
    for vi in range(vv):
        u, v, m = project_to_view(world, proj[vi].float()[b], h, w)
        m = m & valid
        s = bilinear_sample_flat(table[vi], row_offset, u, v, m, h, w)
        s1 = s1 + s
        s2 = s2 + s * s
        count = count + m.float()
    denom = count.clamp(min=1.0)[:, None]
    mean = s1 / denom
    var = (s2 / denom - mean * mean).clamp(min=0.0)
    return var.to(feats.dtype), count


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
REGS_PER_THREAD = 80              # launch bounds 256 x 3 CTAs; a multiple of 8,
                                  # the allocation unit (256 per warp)
# warps per SM the registers hold: 4 x 6; `occupancy` checks it on the card
WARPS_BY_REGS = 4 * (REGS_PER_SM // 4 // (REGS_PER_THREAD * 32))
SMEM_MAX = 232448                 # the most one CTA can opt in to (227 KB)
MIN_BRICK = 16                    # voxels; smaller only when channels force it
BRICKS = ((8, 8, 8), (4, 8, 8), (4, 4, 8), (4, 4, 4), (2, 4, 4), (2, 2, 4),
          (2, 2, 2), (1, 2, 2), (1, 1, 2), (1, 1, 1))
RUNS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
MAX_ITEMS = {WINDOW_MEAN: 3, VARIANCE: 2}  # f32 sums kept in registers


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    brick: Tuple[int, int, int]  # voxels per CTA; a row run is (run, 1, 1)
    grid: int                    # CTAs
    threads: int                 # per CTA, a multiple of 32
    items: int                   # (voxel, 8-channel) items per thread
    ctas_per_sm: int             # resident CTAs the shared memory is cut for
    patch_bytes: int             # one of the two staging buffers
    layout: Tuple[int, ...]      # shared-memory region offsets, then the total

    @property
    def smem_bytes(self) -> int:  # dynamic shared memory per CTA
        return self.layout[-1]


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_regions(v: int, b: int, bvox: int, patch_bytes: int):
    """Bytes of each shared-memory region of one CTA, in the order of
    `Layout` in csrc/back_project.cu, which says how the kernel indexes
    them."""
    return dict(proj=v * b * 16 * 4, world=bvox * 16, row=bvox * 4,
                cnt=bvox * 4, w=2 * bvox * 16, uv=2 * bvox * 4,
                part=(MAX_THREADS // 32) * 8 * 4, box=2 * 8 * 4,
                views=(v + 1) * 4, patch=2 * patch_bytes)


def smem_layout(v: int, b: int, bvox: int, patch_bytes: int) -> Tuple[int, ...]:
    """Offsets of the regions of `smem_regions`, each 16-byte aligned, and
    their total: the layout the kernel is launched with."""
    offsets, at = [], 0
    for size in smem_regions(v, b, bvox, patch_bytes).values():
        offsets.append(at)
        at += _align16(size)
    return (*offsets, at)


def _brick_shape(bvox: int, nvec: int, grid: int) -> Tuple[int, int, int]:
    """(items per thread, threads, resident CTAs per SM) of a brick."""
    items = math.ceil(bvox * nvec / MAX_THREADS)
    threads = 32 * math.ceil(bvox * nvec / items / 32)
    ctas = min(WARPS_BY_REGS // (threads // 32), MAX_CTAS_PER_SM,
               MAX_THREADS_PER_SM // threads, math.ceil(grid / SM_COUNT))
    return items, threads, max(1, ctas)


def _grid(extent: Tuple[int, ...], brick: Tuple[int, int, int]) -> int:
    return math.prod(math.ceil(e / s) for e, s in zip(extent, brick))


def brick_choices(extent: Tuple[int, ...], c: int, mode: int
                  ) -> List[Tuple[int, int, int]]:
    """The bricks a launch over `extent` may take, largest first: those
    whose items fit the registers, of at least MIN_BRICK voxels (unless the
    channels leave only smaller ones). extent: (X, Y, Z) of a dense window,
    or (N,) rows of a coordinate list."""
    nvec = c // 8
    cands = BRICKS if len(extent) == 3 else tuple((r, 1, 1) for r in RUNS)
    fitting = [br for br in cands
               if math.ceil(math.prod(br) * nvec / MAX_THREADS) <= MAX_ITEMS[mode]]
    if not fitting:
        raise ValueError(f"{c} channels are too wide for one CTA")
    return [br for br in fitting if math.prod(br) >= MIN_BRICK] or fitting[:1]


def plan_brick(extent: Tuple[int, ...], c: int, h: int, w: int, v: int,
               b: int, brick: Tuple[int, int, int]) -> LaunchPlan:
    """The launch over `extent` with one CTA per `brick`. As many CTAs
    share an SM as the registers allow, or as the grid needs to run in one
    wave if that is fewer; the staging buffers take the shared memory those
    CTAs leave (whole 128-byte granules), capped at a whole table (h * w
    pixels of c channels)."""
    bvox, grid = math.prod(brick), _grid(extent, brick)
    items, threads, ctas = _brick_shape(bvox, c // 8, grid)
    fixed = smem_layout(v, b, bvox, 0)[-1]
    if fixed > SMEM_MAX:
        raise ValueError(f"{v} views x {b} batches exceed shared memory")
    budget = min(SMEM_PER_SM // ctas - 1024, SMEM_MAX) // SMEM_GRANULE * SMEM_GRANULE
    patch = min(max(0, (budget - fixed) // 2 // 16 * 16), _align16(h * w * c * 2))
    return LaunchPlan(brick, grid, threads, items, ctas, patch,
                      smem_layout(v, b, bvox, patch))


@functools.lru_cache(maxsize=None)
def plan_launch(extent: Tuple[int, ...], c: int, h: int, w: int, v: int,
                b: int = 1, mode: int = WINDOW_MEAN) -> LaunchPlan:
    """Brick, grid and shared memory of one launch (`plan_brick`): the
    largest of the `brick_choices` whose grid fills the card with
    MIN_WAVES waves of resident CTAs, else the one that fills the most.
    (Per-brick setup and view cull favour large bricks; a grid of less
    than two waves leaves SMs idle at its end.)"""
    def waves(br):
        grid = _grid(extent, br)
        return grid / (_brick_shape(math.prod(br), c // 8, grid)[2] * SM_COUNT)

    choices = brick_choices(extent, c, mode)
    full = [br for br in choices if waves(br) >= MIN_WAVES]
    return plan_brick(extent, c, h, w, v, b, full[0] if full else max(choices, key=waves))


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
        lib.bp_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.bp_occupancy.restype = ctypes.c_int
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
    stats: None, or int64 [3] that the kernel adds its brick-view tallies
    to (staged in shared memory, read from device memory, no voxel
    visible)."""
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
        _check("stats", stats, torch.int64, (3,), dev)
    plan = plan_launch((n,) if coords is not None else tuple(dims), c, h, w,
                       vv, bb, mode)
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


def total_launches() -> int:
    return sum(launch_counts.values())


def occupancy(plan: LaunchPlan, mode: int) -> int:
    """CTAs of `plan` that one SM of the current CUDA device holds, from
    the CUDA occupancy calculator on the built kernel; `plan_launch` cuts
    the shared memory for `plan.ctas_per_sm` of them."""
    ctas = ctypes.c_int(0)
    rc = _library().bp_occupancy(mode, plan.items, plan.threads,
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
    (port of back_project.py:147-212).

    dim: (X, Y, Z); interval: window stride in fine voxels; origin [1, 3];
    feats [V, 1, H, W, C]; proj [V, 1, 4, 4]; stats: kernel only, see
    `_launch`.
    Returns (mean [X, Y, Z, C] bf16, count [X, Y, Z] f32).
    """
    if _route(feats, stats) == "cpu":
        return back_project_window_plain(dim, interval, origin, voxel_size,
                                         feats, proj)
    vv, bb, h, w, c = feats.shape
    if bb != 1:
        raise ValueError("back_project_window takes one batch element")
    table = feats.reshape(vv, h * w, c).to(torch.bfloat16).contiguous()
    mean, count = _launch(
        WINDOW_MEAN, table, proj.float().reshape(vv, 1, 16).contiguous(),
        origin.float().reshape(1, 3).contiguous(), None, None,
        dim[0] * dim[1] * dim[2], h, w, dim, interval, voxel_size, stats)
    return mean.reshape(*dim, c), count.reshape(dim)


def back_project_variance(coords: torch.Tensor, valid: torch.Tensor,
                          origin: torch.Tensor, voxel_size: float,
                          feats: torch.Tensor, proj: torch.Tensor,
                          stats: Optional[torch.Tensor] = None):
    """Cross-view feature variance over visible views per voxel, the
    occupancy-init matching cost (port of back_project.py:215-249).

    coords [K, 4] (b, x, y, z) fine units; valid [K] bool; origin [B, 3];
    feats [V, B, H, W, C]; proj [V, B, 4, 4]; stats: kernel only, see
    `_launch`.
    Returns (variance [K, C] in feats' dtype, count [K] f32). The kernel
    takes bf16 features, the dtype of the path.
    """
    if _route(feats, stats) == "cpu":
        return back_project_variance_plain(coords, valid, origin, voxel_size,
                                           feats, proj)
    vv, bb, h, w, c = feats.shape
    if feats.dtype != torch.bfloat16:
        raise ValueError(f"variance kernel takes bf16 features, got {feats.dtype}")
    return _launch(
        VARIANCE, feats.reshape(vv, bb * h * w, c).contiguous(),
        proj.float().reshape(vv, bb, 16).contiguous(),
        origin.float().reshape(bb, 3).contiguous(),
        coords.to(torch.int32).contiguous(),
        valid.to(torch.uint8).contiguous(), coords.shape[0], h, w,
        voxel_size=voxel_size, stats=stats)
