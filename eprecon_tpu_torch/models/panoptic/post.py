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
    voxel_valid [K]. The JAX version scans the queries in order; its
    result has a closed form, computed here at once: a kept thing query
    opens a new segment, a kept stuff query opens one for its class unless
    an earlier kept stuff query of that class did, whose segment it joins;
    ids count the opened segments in query order. A voxel belongs to at
    most one query (its argmax), so the scan's overwrites never meet."""
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
    ok = (keep & (mask_area > 0) & (original_area > 0)
          & (own_all.sum(1) > 0)
          & (mask_area.float() >= overlap_threshold * original_area.float()))

    isthing = labels >= THING_ID_START
    ok_stuff = ok & ~isthing
    # prior[q, p]: p < q is a kept stuff query of q's class
    prior = ((labels[:, None] == labels[None, :]) & ok_stuff[None, :]
             & torch.ones(q, q, dtype=torch.bool, device=dev).tril(-1))
    has_prior = prior.any(dim=1)
    make_new = ok & (isthing | ~has_prior)
    new_id = torch.cumsum(make_new.to(i32), 0, dtype=i32)
    joined = new_id[prior.to(i32).argmax(dim=1)]  # the first such p's id
    seg_id = torch.where(make_new, new_id,
                         torch.where(ok_stuff & has_prior, joined, 0))
    voxel_id = seg_id[vox_best]
    own = fg.gather(0, vox_best[None])[0] & voxel_valid
    voxel_seg = torch.where(own & (voxel_id > 0) & keep.any(), voxel_id, 0)

    # tables by segment id; queries that open none write zeros to slot 0
    slot = torch.where(make_new, new_id, 0).long()
    seg_class = torch.zeros(q + 1, dtype=i32, device=dev).index_put_(
        (slot,), torch.where(make_new, labels, 0))
    seg_isthing = torch.zeros(q + 1, dtype=torch.bool, device=dev).index_put_(
        (slot,), make_new & isthing)
    seg_valid = torch.zeros(q + 1, dtype=torch.bool, device=dev).index_put_(
        (slot,), make_new)
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
