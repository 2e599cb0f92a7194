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
from typing import Optional, Sequence, Tuple

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
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = kernels.load("back_project")
    if lib.bp_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bp_forward.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_longlong, i, i, i, i,
                                   ctypes.c_float, i, p, p, p]
        lib.bp_forward.restype = ctypes.c_int
    return lib


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
            voxel_size: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """table [V, B*H*W, C] bf16; proj [V, B, 16] f32; origin [B, 3] f32;
    coords [N, 4] int32 or None (dense window `dims` * `interval`)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"back-projection kernel needs CUDA tensors, got {dev}")
    vv, rows, c = table.shape
    bb = proj.shape[1]
    if c % 8:
        raise ValueError(f"channels {c} not a multiple of 8")
    if rows != bb * h * w:
        raise ValueError(f"table rows {rows} != B*H*W = {bb * h * w}")
    if vv * bb * 16 * 4 > 48 * 1024:
        raise ValueError(f"{vv} views x {bb} batches exceed shared memory")
    _check("table", table, torch.bfloat16, (vv, rows, c), dev)
    _check("proj", proj, torch.float32, (vv, bb, 16), dev)
    _check("origin", origin, torch.float32, (bb, 3), dev)
    if coords is not None:
        _check("coords", coords, torch.int32, (n, 4), dev)
        _check("valid", valid, torch.uint8, (n,), dev)
    lib = _library()
    out = torch.empty(n, c, dtype=torch.bfloat16, device=dev)
    count = torch.empty(n, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.bp_forward(ptr(table), ptr(proj), ptr(origin), ptr(coords),
                        ptr(valid), vv, bb, h, w, c, n, dims[0], dims[1],
                        dims[2], interval, float(voxel_size), mode,
                        out.data_ptr(), count.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"back_project kernel launch failed: CUDA error {rc}")
    launch_counts[(mode, n, c)] += 1
    return out, count


def total_launches() -> int:
    return sum(launch_counts.values())


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------

def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"back-projection runs on CPU or CUDA, not {t.device}")
    return t.device.type


def back_project_window(dim: Tuple[int, int, int], interval: int,
                        origin: torch.Tensor, voxel_size: float,
                        feats: torch.Tensor, proj: torch.Tensor):
    """Mean of visible-view features for every voxel of a dense window
    (port of back_project.py:147-212).

    dim: (X, Y, Z); interval: window stride in fine voxels; origin [1, 3];
    feats [V, 1, H, W, C]; proj [V, 1, 4, 4].
    Returns (mean [X, Y, Z, C] bf16, count [X, Y, Z] f32).
    """
    if _route(feats) == "cpu":
        return back_project_window_plain(dim, interval, origin, voxel_size,
                                         feats, proj)
    vv, bb, h, w, c = feats.shape
    if bb != 1:
        raise ValueError("back_project_window takes one batch element")
    table = feats.reshape(vv, h * w, c).to(torch.bfloat16).contiguous()
    mean, count = _launch(
        WINDOW_MEAN, table, proj.float().reshape(vv, 1, 16).contiguous(),
        origin.float().reshape(1, 3).contiguous(), None, None,
        dim[0] * dim[1] * dim[2], h, w, dim, interval, voxel_size)
    return mean.reshape(*dim, c), count.reshape(dim)


def back_project_variance(coords: torch.Tensor, valid: torch.Tensor,
                          origin: torch.Tensor, voxel_size: float,
                          feats: torch.Tensor, proj: torch.Tensor):
    """Cross-view feature variance over visible views per voxel, the
    occupancy-init matching cost (port of back_project.py:215-249).

    coords [K, 4] (b, x, y, z) fine units; valid [K] bool; origin [B, 3];
    feats [V, B, H, W, C]; proj [V, B, 4, 4].
    Returns (variance [K, C] in feats' dtype, count [K] f32). The kernel
    takes bf16 features, the dtype of the path.
    """
    if _route(feats) == "cpu":
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
        voxel_size=voxel_size)
