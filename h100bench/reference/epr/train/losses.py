"""TSDF / occupancy losses (port of eprecon_tpu/train/losses.py:17-76;
reference models/neucon_network.py:627-699 and utils.py).

Every loss is masked over a static set: rows outside the mask never
contribute, and the no-positive case is a `torch.where` on the device (no
host sync) that returns 0 * x.sum(), which keeps every input in the graph
with a zero gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def apply_log_transform(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(|x| + 1) (reference utils.py:156-160)."""
    return torch.sign(x) * torch.log(x.abs() + 1.0)


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor, pos_weight) -> torch.Tensor:
    """Mean over `mask` of -[pw * y * log s(x) + (1 - y) * log(1 - s(x))]."""
    m = mask.to(logits.dtype)
    pos = F.softplus(-logits) * targets * pos_weight
    neg = F.softplus(logits) * (1.0 - targets)
    return ((pos + neg) * m).sum() / m.sum().clamp(min=1.0)


def compute_pos_weight(targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """n_neg / n_pos over the masked set (reference neucon_network.py:785-795)."""
    m = mask.float()
    n_all = m.sum()
    n_p = (targets * m).sum()
    return (n_all - n_p) / n_p.clamp(min=1.0)


def occupancy_init_loss(occ_logits: torch.Tensor, tsdf_target: torch.Tensor,
                        occ_target: torch.Tensor, valid: torch.Tensor
                        ) -> torch.Tensor:
    """Occupancy-initialization BCE (reference compute_loss_init,
    neucon_network.py:627-662). tsdf_target is 1 - |tsdf| clamped to
    [0, 1]; supervision covers voxels where it is 0 or occ_target holds."""
    sup = valid & ((tsdf_target == 0.0) | occ_target)
    binary = (tsdf_target > 0.0).float()
    n_p = (binary * sup.float()).sum()
    loss = masked_bce_with_logits(occ_logits, binary, sup,
                                  compute_pos_weight(binary, sup))
    return torch.where(n_p > 0, loss, 0.0 * occ_logits.sum())


def tsdf_occ_loss(tsdf_pred: torch.Tensor, occ_logits: torch.Tensor,
                  tsdf_target: torch.Tensor, occ_target: torch.Tensor,
                  mask: torch.Tensor, pos_weight: float = 1.0,
                  loss_weight: Tuple[float, float] = (1.0, 1.0)) -> torch.Tensor:
    """Per-level occupancy BCE + log-transformed TSDF L1 (reference
    compute_loss, neucon_network.py:665-699)."""
    occ_t = occ_target.float()
    n_p = (occ_t * mask.float()).sum()
    w1 = compute_pos_weight(occ_t, mask) * pos_weight
    occ_loss = masked_bce_with_logits(occ_logits, occ_t, mask, w1)
    sup = (mask & occ_target).float()
    diff = (apply_log_transform(tsdf_pred) - apply_log_transform(tsdf_target)).abs()
    tsdf_loss = (diff * sup).sum() / sup.sum().clamp(min=1.0)
    loss = loss_weight[0] * occ_loss + loss_weight[1] * tsdf_loss
    return torch.where(n_p > 0, loss, 0.0 * (tsdf_pred.sum() + occ_logits.sum()))
