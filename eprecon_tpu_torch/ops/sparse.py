"""Capacity-padded voxel sets: compaction and dense <-> sparse conversion
(port of eprecon_tpu/ops/sparse.py:300-389; the sparse conv engine of that
module is not on the serving path and is not ported).

A voxel set is `SparseVoxels(coords int32 [K, 4] (b, x, y, z), feats [K, C],
valid bool [K])` with a static capacity K.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from eprecon_tpu_torch.ops.grid import dense_coords


class SparseVoxels(NamedTuple):
    coords: torch.Tensor  # int32 [K, 4]
    feats: torch.Tensor   # [K, C]
    valid: torch.Tensor   # bool [K]


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
