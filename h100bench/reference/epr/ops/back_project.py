"""Frozen copy of the port's plain back-projection (the plain versions of
the window mean and the cross-view variance, forward and fixed-point
backward), bound into autograd with torch.autograd.Function in place of
the port's custom ops and CUDA kernels. Same arithmetic, same order."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from h100bench.reference.epr.ops.grid import dense_coords

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
# the public functions the model calls, with their gradients
# ---------------------------------------------------------------------------

class _WindowMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, origin, proj, dim, interval, voxel_size):
        mean, count = back_project_window_plain(dim, interval, origin,
                                                voxel_size, feats, proj)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(origin, proj, count)
        ctx.args = (dim, interval, voxel_size, feats.shape, feats.dtype)
        return mean, count

    @staticmethod
    def backward(ctx, ct, _):
        origin, proj, count = ctx.saved_tensors
        dim, interval, voxel_size, shape, dtype = ctx.args
        grad = window_backward_plain(dim, interval, origin, voxel_size, proj,
                                     count, ct, shape[2], shape[3])
        return grad.to(dtype).reshape(shape), None, None, None, None, None


class _VarianceWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, origin, proj, dim, interval, voxel_size):
        var, count = back_project_variance_window_plain(
            dim, interval, origin, voxel_size, feats, proj)
        ctx.mark_non_differentiable(count)
        ctx.save_for_backward(feats, origin, proj, count)
        ctx.args = (dim, interval, voxel_size)
        return var, count

    @staticmethod
    def backward(ctx, ct, _):
        feats, origin, proj, count = ctx.saved_tensors
        dim, interval, voxel_size = ctx.args
        grad = variance_window_backward_plain(dim, interval, origin,
                                              voxel_size, feats, proj, count,
                                              ct)
        return (grad.to(feats.dtype).reshape(feats.shape), None, None, None,
                None, None)


def back_project_window(dim, interval, origin, voxel_size, feats, proj):
    """Mean of visible-view features per voxel of a dense window:
    (mean [X, Y, Z, C] bf16, count [X, Y, Z] f32)."""
    return _WindowMean.apply(feats, origin, proj, tuple(dim), interval,
                             float(voxel_size))


def back_project_variance_window(dim, interval, origin, voxel_size, feats,
                                 proj):
    """Cross-view variance per voxel of a dense window:
    (variance [X*Y*Z, C] in feats' dtype, count [X*Y*Z] f32)."""
    return _VarianceWindow.apply(feats, origin, proj, tuple(dim), interval,
                                 float(voxel_size))
