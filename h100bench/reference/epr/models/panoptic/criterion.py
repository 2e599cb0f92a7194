"""Mask2Former-style set criterion with static-shape targets (port of
eprecon_tpu/models/panoptic/criterion.py:26-179; reference
models/criterion.py:85-296 and models/neucon_network.py:155-191).

Per-voxel GT labels become `max_instances` fixed target slots with
validity flags and a supervised-voxel mask. nyu40 ids keep only the 20
valid classes, remapped to 1..20 (0 = no object); instances of
`min_instance_voxels` voxels or fewer are dropped.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.epr.models.panoptic.matcher import hungarian_match

VALID_CLASSES = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24,
                          28, 33, 34, 36, 39], np.int64)
MIN_INSTANCE_VOXELS = 100
MAX_SEMANTIC_ID = 41          # nyu40 ids
MAX_INSTANCE_ID = 4096        # GT instance id bound for bucketing


class PanopticTargets(NamedTuple):
    labels: torch.Tensor      # [T] classes 1..20 (0 invalid)
    masks: torch.Tensor       # bool [T, K]
    valid: torch.Tensor       # bool [T]
    voxel_mask: torch.Tensor  # bool [K]: union of valid masks and the input mask


def nyu40_to_20(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nyu40 ids -> 1..20; returns (mapped, is_valid)."""
    table = np.zeros(MAX_SEMANTIC_ID, np.int64)
    table[VALID_CLASSES] = np.arange(1, 21)
    mapped = torch.as_tensor(table, device=labels.device)[
        labels.long().clamp(0, MAX_SEMANTIC_ID - 1)]
    return mapped, (mapped > 0) & (labels < MAX_SEMANTIC_ID)


def build_targets(semantic: torch.Tensor, instance: torch.Tensor,
                  voxel_valid: torch.Tensor, max_instances: int,
                  min_instance_voxels: int = MIN_INSTANCE_VOXELS
                  ) -> PanopticTargets:
    """Per-voxel GT (semantic nyu40 ids [K], instance ids [K], 0 = none,
    supervised voxels [K]) -> fixed-slot instance targets with the
    majority class of each instance. The slots hold the smallest
    `max_instances` instance ids present, in order."""
    dev = semantic.device
    inst = instance.long().clamp(0, MAX_INSTANCE_ID - 1)
    live = voxel_valid & (inst > 0)
    skeys = torch.sort(torch.where(live, inst, MAX_INSTANCE_ID)).values
    head = torch.cat([skeys[:1] < MAX_INSTANCE_ID,
                      (skeys[1:] != skeys[:-1]) & (skeys[1:] < MAX_INSTANCE_ID)])
    slot_ids = torch.sort(torch.where(head, skeys, MAX_INSTANCE_ID)).values
    slot_ids = F.pad(slot_ids, (0, max(0, max_instances - slot_ids.shape[0])),
                     value=MAX_INSTANCE_ID)[:max_instances]
    slot_valid = slot_ids < MAX_INSTANCE_ID
    pos = torch.searchsorted(slot_ids, inst).clamp(0, max_instances - 1)
    hit = live & (slot_ids[pos] == inst)
    vox_slot = torch.where(hit, pos, max_instances)
    sem = semantic.long().clamp(0, MAX_SEMANTIC_ID - 1)
    pair = vox_slot * MAX_SEMANTIC_ID + torch.where(hit, sem, 0)
    counts = torch.zeros((max_instances + 1) * MAX_SEMANTIC_ID, dtype=torch.long,
                         device=dev).index_add_(0, pair, hit.long())
    counts = counts.reshape(max_instances + 1, MAX_SEMANTIC_ID)[:max_instances]
    mapped, cls_ok = nyu40_to_20(counts.argmax(dim=1))   # first maximum
    keep = slot_valid & cls_ok & (counts.sum(1) > min_instance_voxels)
    masks = ((vox_slot[None, :] == torch.arange(max_instances, device=dev)[:, None])
             & hit[None, :] & keep[:, None])
    voxel_mask = masks.any(0) & voxel_valid
    return PanopticTargets(torch.where(keep, mapped, 0), masks, keep, voxel_mask)


def loss_labels(pred_logits: torch.Tensor, targets: PanopticTargets,
                assign: torch.Tensor, eos_coef: float = 0.1) -> torch.Tensor:
    """Weighted cross entropy over the queries (reference criterion.py:120-142)."""
    q, nc1 = pred_logits.shape
    ok = targets.valid & (assign >= 0)
    target_classes = torch.zeros(q + 1, dtype=torch.long, device=pred_logits.device)
    target_classes.scatter_(0, torch.where(ok, assign, q),
                            torch.where(ok, targets.labels.long(), 0))
    target_classes = target_classes[:q]
    nll = -F.log_softmax(pred_logits, dim=-1).gather(1, target_classes[:, None])[:, 0]
    w_table = torch.ones(nc1, device=pred_logits.device)
    w_table[0] = eos_coef
    w = w_table[target_classes]
    return (nll * w).sum() / w.sum().clamp(min=1e-6)


def loss_masks(pred_masks: torch.Tensor, targets: PanopticTargets,
               assign: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positive-weighted sigmoid BCE + dice over the matched pairs
    (reference criterion.py:20-65, :144-174). Returns (loss_mask, loss_dice)."""
    vm = targets.voxel_mask.float()
    n_vox = vm.sum().clamp(min=1.0)
    ok = targets.valid & (assign >= 0)
    n_masks = ok.float().sum().clamp(min=1.0)
    src = pred_masks[assign.clamp(min=0)]
    tgt = targets.masks.float() * vm[None, :]
    n_p = tgt.sum(1)
    pw = ((n_vox - n_p) / n_p.clamp(min=1.0)).clamp(max=30.0)
    pos = F.softplus(-src) * tgt * pw[:, None]
    neg = F.softplus(src) * (1.0 - tgt) * vm[None, :]
    bce = (pos + neg).sum(1) / n_vox
    l_mask = torch.where(ok, bce, 0.0).sum() / n_masks
    probs = torch.sigmoid(src) * vm[None, :]
    num = 2.0 * (probs * tgt).sum(1)
    den = probs.sum(1) + n_p
    dice = 1.0 - (num + 1.0) / (den + 1.0)
    l_dice = torch.where(ok, dice, 0.0).sum() / n_masks
    return l_mask, l_dice


def set_criterion(pred_logits_layers: torch.Tensor,
                  pred_masks_layers: torch.Tensor, targets: PanopticTargets,
                  class_weight: float = 0.2, mask_weight: float = 0.8,
                  dice_weight: float = 0.8, eos_coef: float = 0.1
                  ) -> torch.Tensor:
    """Panoptic loss over the final and auxiliary decoder layers, each
    matched anew, summed and divided by 3 (reference criterion.py:196-280,
    neucon_network.py:605-611). pred_logits_layers [L+1, Q, nc+1];
    pred_masks_layers [L+1, Q, K]. All layers are matched in one batched
    auction."""
    assigns = hungarian_match(pred_logits_layers, pred_masks_layers,
                              targets.labels, targets.masks.float(),
                              targets.valid, targets.voxel_mask,
                              class_weight, mask_weight, dice_weight)
    total = pred_masks_layers.new_zeros(())
    for logits, masks, assign in zip(pred_logits_layers, pred_masks_layers,
                                     assigns):
        lc = loss_labels(logits, targets, assign, eos_coef)
        lm, ld = loss_masks(masks, targets, assign)
        total = total + class_weight * lc + mask_weight * lm + dice_weight * ld
    total = total / 3.0
    return torch.where(targets.valid.any(), total,
                       0.0 * pred_masks_layers.sum())
