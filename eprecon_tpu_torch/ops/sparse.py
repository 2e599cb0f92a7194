"""Capacity-padded voxel sets and the sparse voxel engine (port of
eprecon_tpu/ops/sparse.py; reference: torchsparse hashing, voxelize and
devoxelize, ops/torchsparse_utils.py:15-106, and spconv submanifold
convs, models/modules.py:249-271).

A voxel set is `SparseVoxels(coords int32 [K, 4] (b, x, y, z), feats [K, C],
valid bool [K])` with a static capacity K. Filtering flips `valid` flags;
`compact` re-packs a mask into the leading slots.

The engine (`HashedGrid` ... `downsample_coords`) is the research path of
`models/spvcnn.py`, off the serving path as in the JAX package:
  * coordinate lookup is O(1): row indices are scattered into a dense
    index volume over a static window at a dynamic min corner, and a query
    is one gather. Where several rows hold one coordinate, the table keeps
    the largest row (`scatter_reduce` "amax"): XLA leaves that winner
    unspecified and CUDA's `index_put_` is nondeterministic with
    duplicates, so the port fixes it, on the CPU and the card alike;
  * a sparse 3D conv is a per-offset neighbour gather, a matmul and an
    accumulation (`torch.matmul`, as the JAX version leaves its products
    to XLA outside any kernel);
  * point <-> voxel (de)voxelisation is unique coordinates through the
    index table, segment means (`index_add_`) and trilinear weights.
Row indices are int64, torch's index type (int32 in the JAX version).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from eprecon_tpu_torch.ops.grid import dense_coords


class SparseVoxels(NamedTuple):
    coords: torch.Tensor  # int32 [K, 4]
    feats: torch.Tensor   # [K, C]
    valid: torch.Tensor   # bool [K]

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum()


class HashedGrid(NamedTuple):
    """SparseVoxels and their dense O(1)-lookup index volume: table int64
    [B, Wx, Wy, Wz] holds the row of the voxel at (b, offset + (x, y, z)),
    or -1. The window (the table's shape) is static, its min corner
    `offset` [3] is data."""
    voxels: SparseVoxels
    table: torch.Tensor
    offset: torch.Tensor


def build_hash(sv: SparseVoxels, window: Tuple[int, int, int],
               offset: Optional[torch.Tensor] = None,
               n_batch: int = 1) -> HashedGrid:
    """The index table of a voxel set over `window`, at `offset` (default:
    the per-axis minimum of the valid coords). Rows outside the window
    are not indexed, so lookups of them miss; of rows sharing a
    coordinate, the largest is indexed."""
    coords = sv.coords.long()
    if offset is None:
        big = 2 ** 30
        offset = torch.where(sv.valid[:, None], coords[:, 1:], big).amin(0)
        offset = torch.where(offset == big, 0, offset)
    offset = offset.long()
    w = coords[:, 1:] - offset[None, :]
    inb = (sv.valid & (w >= 0).all(dim=1) & (w[:, 0] < window[0])
           & (w[:, 1] < window[1]) & (w[:, 2] < window[2]))
    b = coords[:, 0].clamp(0, n_batch - 1)
    lin = ((b * window[0] + w[:, 0]) * window[1] + w[:, 1]) * window[2] + w[:, 2]
    size = n_batch * window[0] * window[1] * window[2]
    lin = torch.where(inb, lin, size)
    rows = torch.arange(sv.capacity, device=coords.device)
    table = torch.full((size + 1,), -1, dtype=torch.long, device=coords.device)
    table = table.scatter_reduce(0, lin, torch.where(inb, rows, -1), "amax")
    return HashedGrid(sv, table[:-1].reshape(n_batch, *window), offset)


def lookup(grid: HashedGrid, query_coords: torch.Tensor,
           query_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row of each query coord [..., 4] in the grid, -1 where absent; one
    gather (torchsparse sphashquery, ops/torchsparse_utils.py:21).
    query_valid [N] masks the queries of the leading axis."""
    nb, wx, wy, wz = grid.table.shape
    flat = query_coords.reshape(-1, 4).long()
    w = flat[:, 1:] - grid.offset[None, :]
    b = flat[:, 0]
    inb = ((w[:, 0] >= 0) & (w[:, 0] < wx) & (w[:, 1] >= 0) & (w[:, 1] < wy)
           & (w[:, 2] >= 0) & (w[:, 2] < wz) & (b >= 0) & (b < nb))
    if query_valid is not None:
        lead = query_coords.shape[:-1]
        qv = query_valid.reshape(query_valid.shape
                                 + (1,) * (len(lead) - query_valid.ndim))
        inb = inb & qv.expand(lead).reshape(-1)
    rows = grid.table[b.clamp(0, nb - 1), w[:, 0].clamp(0, wx - 1),
                      w[:, 1].clamp(0, wy - 1), w[:, 2].clamp(0, wz - 1)]
    return torch.where(inb, rows, -1).reshape(query_coords.shape[:-1])


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [K, C] at idx [...], zeros where idx is -1 -> [..., C]."""
    out = feats[idx.clamp(min=0)]
    return torch.where((idx >= 0)[..., None], out, 0.0)


def kernel_offsets(ks: int, dims: int = 3) -> np.ndarray:
    """Integer kernel offsets in torchsparse order: ks=3 -> the 27 of
    {-1, 0, 1}^3, ks=2 -> the 8 of {0, 1}^3."""
    if ks % 2 == 1:
        r = np.arange(-(ks // 2), ks // 2 + 1)
    else:
        r = np.arange(0, ks)
    grids = np.meshgrid(*([r] * dims), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


def neighbor_map(grid: HashedGrid, query_coords: torch.Tensor,
                 query_valid: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Row in `grid` of each query coord plus each kernel offset, -1 where
    absent: int64 [K, n_offsets], built once per (coords, kernel) and
    shared by the conv layers (torchsparse's kmap cache)."""
    off = torch.as_tensor(offsets, device=query_coords.device).long()
    q = query_coords.long()
    nb = q[:, None, 1:] + off[None, :, :]
    b = q[:, None, :1].expand(*nb.shape[:2], 1)
    return lookup(grid, torch.cat([b, nb], dim=-1), query_valid)


def sparse_conv_apply(feats: torch.Tensor, nmap: torch.Tensor,
                      weights: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_valid: Optional[torch.Tensor] = None,
                      group: int = 9) -> torch.Tensor:
    """Gather-GEMM-accumulate sparse conv: feats [K, Cin], nmap [K_out, O]
    neighbour rows, weights [O, Cin, Cout] -> [K_out, Cout]. Offsets go
    in groups of `group`: one gather [K, G, Cin] and one [K, G*Cin] x
    [G*Cin, Cout] product each, as the JAX version groups them."""
    n_off, cin, cout = nmap.shape[1], feats.shape[-1], weights.shape[-1]
    k = nmap.shape[0]
    out = None
    for o0 in range(0, n_off, group):
        o1 = min(o0 + group, n_off)
        g = gather_rows(feats, nmap[:, o0:o1])
        term = torch.matmul(g.reshape(k, (o1 - o0) * cin),
                            weights[o0:o1].reshape((o1 - o0) * cin, cout))
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0.0)
    return out


# ---------------------------------------------------------------------------
# point <-> voxel (torchsparse ops/torchsparse_utils.py equivalents)
# ---------------------------------------------------------------------------

class PointSet(NamedTuple):
    """Point cloud: float coords (x, y, z) and an integer batch index."""
    xyz: torch.Tensor    # f32 [K, 3]
    batch: torch.Tensor  # int [K]
    feats: torch.Tensor  # [K, C]
    valid: torch.Tensor  # bool [K]


def segment_mean(values: torch.Tensor, seg: torch.Tensor,
                 member: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of values [N, C] per segment seg [N] in [0, k] (k: dropped),
    over the rows where `member`."""
    sums = torch.zeros(k + 1, values.shape[-1], dtype=values.dtype,
                       device=values.device).index_add_(0, seg, values)
    cnts = torch.zeros(k + 1, dtype=values.dtype,
                       device=values.device).index_add_(0, seg,
                                                        member.to(values.dtype))
    return sums[:k] / cnts[:k, None].clamp(min=1.0)


def _unique_coords(coords: torch.Tensor, valid: torch.Tensor, window,
                   n_batch: int = 1):
    """Deduplicate [K, 4] coords into leading slots through the index
    table: each distinct coord keeps one representative row (the largest,
    `build_hash`), and slots follow the representatives' order. Returns
    (the unique set's grid, with zero-channel feats; the representative row
    of each slot [K]; the slot of every input row [K], -1 if invalid)."""
    k = coords.shape[0]
    rows = torch.arange(k, device=coords.device)
    tmp = build_hash(SparseVoxels(coords, torch.zeros(k, 0, device=coords.device),
                                  valid), window, n_batch=n_batch)
    is_rep = valid & (lookup(tmp, coords, valid) == rows)
    usv, (rep_rows,), _ = compact(is_rep, coords, k, rows[:, None])
    ugrid = build_hash(usv, window, offset=tmp.offset, n_batch=n_batch)
    return ugrid, rep_rows[:, 0], lookup(ugrid, coords, valid)


def voxelize(points: PointSet, res: float, window: Tuple[int, int, int],
             n_batch: int = 1) -> Tuple[HashedGrid, torch.Tensor]:
    """Quantise points at `res` and average their features per voxel
    (initial_voxelize, ops/torchsparse_utils.py:15-35). Returns (the voxel
    grid, K rows padded past the unique count; each point's voxel row
    [K], -1 for invalid points)."""
    k = points.xyz.shape[0]
    vox = torch.floor(points.xyz / res).to(torch.int32)
    coords = torch.cat([points.batch[:, None].to(torch.int32), vox], dim=1)
    ugrid, _, idx_query = _unique_coords(coords, points.valid, window, n_batch)
    member = points.valid & (idx_query >= 0)
    mean = segment_mean(torch.where(points.valid[:, None], points.feats, 0.0),
                        torch.where(idx_query >= 0, idx_query, k), member, k)
    uv = ugrid.voxels
    mean = torch.where(uv.valid[:, None], mean, 0.0)
    return (HashedGrid(SparseVoxels(uv.coords, mean, uv.valid), ugrid.table,
                       ugrid.offset), idx_query)


def point_to_voxel(grid: HashedGrid, points: PointSet,
                   idx_query: torch.Tensor) -> SparseVoxels:
    """Average point features into the grid's voxel slots
    (ops/torchsparse_utils.py:40-63)."""
    k = grid.voxels.capacity
    member = (idx_query >= 0) & points.valid
    mean = segment_mean(points.feats, torch.where(member, idx_query, k),
                        member, k)
    mean = torch.where(grid.voxels.valid[:, None], mean, 0.0)
    return SparseVoxels(grid.voxels.coords, mean, grid.voxels.valid)


def trilinear_links(grid: HashedGrid, points: PointSet, res: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8 corner rows [K, 8] of each point in `grid` at voxel size
    `res`, and their trilinear weights [K, 8] (zero for missing corners,
    not renormalised, as torchsparse's calc_ti_weights)."""
    p = points.xyz / res
    base = torch.floor(p)
    frac = p - base
    corners = torch.as_tensor(kernel_offsets(2), device=p.device)
    cc = base.long()[:, None, :] + corners[None].long()
    b = points.batch.long()[:, None, None].expand(*cc.shape[:2], 1)
    idx = lookup(grid, torch.cat([b, cc], dim=-1), points.valid)
    w = torch.ones(idx.shape, dtype=p.dtype, device=p.device)
    for d in range(3):
        cd = corners[:, d].to(p.dtype)
        w = w * (cd[None, :] * frac[:, d:d + 1]
                 + (1 - cd[None, :]) * (1 - frac[:, d:d + 1]))
    return idx, torch.where(idx >= 0, w, 0.0)


def devoxelize_trilinear(grid: HashedGrid, points: PointSet,
                         res: float) -> torch.Tensor:
    """Trilinear interpolation of the voxel features at the points
    (voxel_to_point, ops/torchsparse_utils.py:68-106) -> [K, C]."""
    idx, w = trilinear_links(grid, points, res)
    return torch.einsum("ko,koc->kc", w, gather_rows(grid.voxels.feats, idx))


def downsample_coords(sv: SparseVoxels, window: Tuple[int, int, int],
                      n_batch: int = 1) -> Tuple[HashedGrid, torch.Tensor]:
    """The output coordinates of a stride-2 sparse conv, unique(floor(c /
    2)), over the coarse `window`. Returns (the coarse grid with zero
    feats, each fine row's parent row [K])."""
    coarse = torch.cat([sv.coords[:, :1],
                        torch.div(sv.coords[:, 1:], 2, rounding_mode="floor")],
                       dim=1)
    ugrid, _, parent = _unique_coords(coarse, sv.valid, window, n_batch)
    return ugrid, parent


def compact(mask: torch.Tensor, coords: torch.Tensor, capacity: int,
            *feat_arrays: torch.Tensor, score: Optional[torch.Tensor] = None
            ) -> Tuple[SparseVoxels, Tuple[torch.Tensor, ...], torch.Tensor]:
    """Pack rows where `mask` is True into the first `capacity` slots, in
    their original order. With `score` [N], overflow keeps the
    highest-scoring rows (still emitted in original order) instead of the
    first `capacity`. Returns (SparseVoxels with the first feat array or
    zero-channel feats, the packed arrays, overflow count)."""
    n = mask.shape[0]
    k_eff = min(capacity, n)
    dev = mask.device
    if score is None:
        key = torch.where(mask, torch.arange(n, device=dev), n)
        order = torch.topk(key, k_eff, largest=False, sorted=True).indices
        sel_valid = key[order] < n
    else:
        s = torch.where(mask, score.float(), float("-inf"))
        cand = torch.topk(s, k_eff, sorted=False).indices
        sorted_key = torch.sort(torch.where(mask[cand], cand, n)).values
        order = sorted_key.clamp(max=n - 1)
        sel_valid = sorted_key < n
    if k_eff < capacity:
        pad = capacity - k_eff
        order = torch.cat([order, torch.zeros(pad, dtype=order.dtype, device=dev)])
        sel_valid = torch.cat([sel_valid, torch.zeros(pad, dtype=torch.bool,
                                                      device=dev)])

    def take(a):
        v = sel_valid.reshape(sel_valid.shape + (1,) * (a.ndim - 1))
        return torch.where(v, a[order], 0)

    out_coords = take(coords).to(torch.int32)
    packed = tuple(take(a) for a in feat_arrays)
    overflow = (mask.sum() - capacity).clamp(min=0).to(torch.int32)
    feats = packed[0] if packed else torch.zeros(capacity, 0, device=dev)
    return SparseVoxels(out_coords, feats, sel_valid), packed, overflow


def sparse_to_dense(coords: torch.Tensor, values: torch.Tensor,
                    valid: torch.Tensor, shape: Sequence[int],
                    default: float = 0.0) -> torch.Tensor:
    """Scatter [K, C] values at [K, 3] xyz coords into [X, Y, Z, C];
    invalid or out-of-range rows are dropped."""
    shape = tuple(int(s) for s in shape)
    x, y, z = coords[:, 0].long(), coords[:, 1].long(), coords[:, 2].long()
    inb = (valid & (x >= 0) & (x < shape[0]) & (y >= 0) & (y < shape[1])
           & (z >= 0) & (z < shape[2]))
    total = shape[0] * shape[1] * shape[2]
    flat = torch.where(inb, (x * shape[1] + y) * shape[2] + z, total)
    vals = values.reshape(values.shape[0], -1)
    dense = torch.full((total + 1, vals.shape[1]), default, dtype=vals.dtype,
                       device=vals.device)
    dense[flat] = vals.masked_fill(~inb[:, None], default)
    return dense[:-1].reshape(*shape, vals.shape[1])


def dense_to_sparse(dense: torch.Tensor, mask: torch.Tensor, capacity: int,
                    batch_index: int = 0,
                    score: Optional[torch.Tensor] = None
                    ) -> Tuple[SparseVoxels, torch.Tensor]:
    """Compact a dense [X, Y, Z, C] volume's masked voxels into K slots
    (score [X, Y, Z]: on overflow keep the highest-scoring voxels)."""
    shape = dense.shape[:3]
    n = shape[0] * shape[1] * shape[2]
    coords3 = dense_coords(shape, dense.device).reshape(-1, 3)
    b = torch.full((n, 1), batch_index, dtype=torch.int32, device=dense.device)
    sv, (feats,), overflow = compact(
        mask.reshape(-1), torch.cat([b, coords3], dim=1), capacity,
        dense.reshape(n, dense.shape[-1]),
        score=None if score is None else score.reshape(-1))
    return SparseVoxels(sv.coords, feats, sv.valid), overflow
