"""Panoptic inference post-processing (port of
eprecon_tpu/models/panoptic/post.py:32-135; reference models/
mask3dformer.py:506-625).

Segment tables are static, sized [Q+1]: segment id s in 1..Q, with
seg_class / seg_isthing / seg_valid indexed by s; slot 0 means "none".
They plug into gru_fusion.panoptic_instance_match.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

THING_ID_START = 3  # ids 1..2 = wall/floor (stuff), 3..20 things


class PanopticSeg(NamedTuple):
    voxel_seg: torch.Tensor    # int32 [K] segment id per voxel (0 = none)
    seg_class: torch.Tensor    # int32 [Q+1]
    seg_isthing: torch.Tensor  # bool [Q+1]
    seg_valid: torch.Tensor    # bool [Q+1]


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       voxel_valid: torch.Tensor,
                       object_mask_threshold: float = 0.3,
                       overlap_threshold: float = 0.5,
                       num_classes: int = 20) -> PanopticSeg:
    """mask_cls [Q, nc+1] logits; mask_pred [Q, K] mask logits;
    voxel_valid [K]. Queries are visited in order (the JAX scan, unrolled
    into a loop of tensor ops: no host sync)."""
    q, k = mask_pred.shape
    dev = mask_pred.device
    i32 = torch.int32
    probs = torch.softmax(mask_cls, dim=-1)
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1).to(i32)  # first maximum, as jnp.argmax
    keep = (labels != 0) & (scores > object_mask_threshold)

    mprob = torch.sigmoid(mask_pred)
    weighted = torch.where(keep[:, None], scores[:, None] * mprob,
                           float("-inf"))
    vox_best = weighted.argmax(dim=0)  # [K]
    best_is = vox_best[None, :] == torch.arange(q, device=dev)[:, None]
    fg = mprob >= 0.5
    mask_area = (best_is & voxel_valid).sum(1)
    original_area = (fg & voxel_valid).sum(1)
    own_all = best_is & fg & voxel_valid
    ok_all = (keep & (mask_area > 0) & (original_area > 0)
              & (own_all.sum(1) > 0)
              & (mask_area.float() >= overlap_threshold * original_area.float()))

    voxel_seg = torch.zeros(k, dtype=i32, device=dev)
    seg_class = torch.zeros(q + 1, dtype=i32, device=dev)
    seg_isthing = torch.zeros(q + 1, dtype=torch.bool, device=dev)
    seg_valid = torch.zeros(q + 1, dtype=torch.bool, device=dev)
    stuff_memory = torch.zeros(num_classes + 1, dtype=i32, device=dev)
    current_id = torch.zeros(1, dtype=i32, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    # per-query values are 1-element tensors: indexing with them never
    # reads back to the host
    for qi in range(q):
        cls = labels[qi:qi + 1]
        ok = ok_all[qi:qi + 1]
        isthing = cls >= THING_ID_START
        cls_slot = cls.clamp(0, num_classes).long()
        stuff_existing = stuff_memory[cls_slot]
        reuse_stuff = ok & ~isthing & (stuff_existing > 0)
        make_new = ok & (isthing | (stuff_existing == 0))
        new_id = current_id + 1
        seg_id = torch.where(reuse_stuff, stuff_existing,
                             torch.where(make_new, new_id, 0))
        voxel_seg = torch.where(own_all[qi] & (seg_id > 0), seg_id, voxel_seg)
        # conditional writes: slot 0 is scratch when the condition is False
        widx = torch.where(make_new, new_id.long(), zero)
        seg_class[widx] = torch.where(make_new, cls, seg_class[zero])
        seg_isthing[widx] = torch.where(make_new, isthing, seg_isthing[zero])
        seg_valid[widx] = make_new | seg_valid[zero]
        new_stuff = make_new & ~isthing
        sidx = torch.where(new_stuff, cls_slot, zero)
        stuff_memory[sidx] = torch.where(new_stuff, new_id, stuff_memory[zero])
        current_id = torch.where(make_new, new_id, current_id)

    seg_class[0] = 0
    seg_isthing[0] = False
    seg_valid[0] = False
    voxel_seg = torch.where(keep.any(), voxel_seg, 0)
    return PanopticSeg(voxel_seg, seg_class, seg_isthing, seg_valid)


def semantic_inference(mask_cls: torch.Tensor,
                       mask_pred: torch.Tensor) -> torch.Tensor:
    """[Q, nc+1] class logits x [Q, K] mask logits -> [nc, K] per-class
    scores (reference mask3dformer.py:506-510)."""
    probs = torch.softmax(mask_cls, dim=-1)[:, 1:]
    return torch.einsum("qc,qk->ck", probs, torch.sigmoid(mask_pred))


class InstancePreds(NamedTuple):
    pred_masks: torch.Tensor    # bool [N, K]
    scores: torch.Tensor        # f32 [N]
    pred_classes: torch.Tensor  # int32 [N]
    valid: torch.Tensor         # bool [N]


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       voxel_valid: torch.Tensor, num_classes: int = 20,
                       panoptic_on: bool = True) -> InstancePreds:
    """The Q/2 best (query, class) pairs as instances, each scored by its
    class probability times its mask's mean probability over its voxels;
    with `panoptic_on`, only thing classes are valid (reference
    mask3dformer.py:583-625)."""
    q = mask_pred.shape[0]
    scores = torch.softmax(mask_cls, dim=-1)[:, 1:]
    vals, idx = torch.topk(scores.reshape(-1), q // 2)
    labels = (idx % num_classes + 1).to(torch.int32)
    masks = mask_pred[idx // num_classes]
    keep = (labels >= THING_ID_START if panoptic_on
            else torch.ones_like(labels, dtype=torch.bool))
    bin_masks = (masks > 0) & voxel_valid[None, :]
    mask_probs = torch.sigmoid(masks) * bin_masks
    mask_score = mask_probs.sum(1) / (bin_masks.sum(1) + 1e-6)
    return InstancePreds(bin_masks, vals * mask_score, labels, keep)
