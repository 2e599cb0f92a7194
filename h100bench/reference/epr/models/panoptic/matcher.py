"""Hungarian matching by an eps auction (port of
eprecon_tpu/models/panoptic/matcher.py:25-140; reference models/matcher.py).

Cost terms as in the reference: cost_class = -prob[target class],
cost_mask = mean-per-voxel sigmoid BCE, cost_dice = soft dice. The
assignment is the JAX package's Jacobi auction (one eps = 1e-4 * span
phase, ties to the lowest target index, at most `max_iters` rounds), run
for all decoder layers as one batched problem, as its vmap does: each
layer's rounds stop when its targets are all assigned. Convergence is read
on the host once every CHECK_EVERY rounds, not every round.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = 1e9
CHECK_EVERY = 8  # auction rounds between host convergence checks


def batch_sigmoid_ce_cost(logits: torch.Tensor, targets: torch.Tensor,
                          voxel_mask: torch.Tensor) -> torch.Tensor:
    """[..., Q, L] logits vs [T, L] binary targets -> [..., Q, T] mean BCE
    per voxel of voxel_mask [L]."""
    m = voxel_mask.to(logits.dtype)
    n = m.sum().clamp(min=1.0)
    pos = F.softplus(-logits) * m
    neg = F.softplus(logits) * m
    return (pos @ targets.T + neg @ ((1.0 - targets) * m).T) / n


def batch_dice_cost(logits: torch.Tensor, targets: torch.Tensor,
                    voxel_mask: torch.Tensor) -> torch.Tensor:
    """[..., Q, L] x [T, L] -> [..., Q, T] soft dice cost."""
    m = voxel_mask.to(logits.dtype)
    probs = torch.sigmoid(logits) * m
    tm = targets * m
    num = 2.0 * (probs @ tm.T)
    den = probs.sum(-1)[..., None] + tm.sum(-1)
    return 1.0 - (num + 1.0) / (den + 1.0)


def match_cost_matrix(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                      tgt_labels: torch.Tensor, tgt_masks: torch.Tensor,
                      tgt_valid: torch.Tensor, voxel_mask: torch.Tensor,
                      cost_class: float = 0.2, cost_mask: float = 0.8,
                      cost_dice: float = 0.8) -> torch.Tensor:
    """[..., Q, T] matching cost (reference matcher.py:75-113); invalid
    targets cost BIG."""
    prob = torch.softmax(pred_logits, dim=-1)
    c_class = -prob[..., tgt_labels.long()]
    c_mask = batch_sigmoid_ce_cost(pred_masks, tgt_masks, voxel_mask)
    c_dice = batch_dice_cost(pred_masks, tgt_masks, voxel_mask)
    cost = cost_class * c_class + cost_mask * c_mask + cost_dice * c_dice
    return torch.where(tgt_valid, cost, BIG)


def _assigned_query(owner: torch.Tensor, tn: int) -> torch.Tensor:
    """owner [L, Q] (target per query, -1 free) -> assign [L, T] (query
    per target, -1 none)."""
    ln, qn = owner.shape
    assign = torch.full((ln, tn + 1), -1, dtype=torch.long, device=owner.device)
    qidx = torch.arange(qn, device=owner.device).expand(ln, qn)
    assign.scatter_(1, torch.where(owner >= 0, owner, tn),
                    torch.where(owner >= 0, qidx, -1))
    return assign[:, :tn]


def auction_assign(cost: torch.Tensor, tgt_valid: torch.Tensor,
                   max_iters: int = 2000) -> torch.Tensor:
    """Min-cost assignment of each valid target (column) to a distinct
    query (row), for one cost [Q, T] or a batch [L, Q, T] solved
    independently. Returns [T] or [L, T] query per target, -1 where the
    target is invalid."""
    single = cost.ndim == 2
    cost = cost[None] if single else cost
    ln, qn, tn = cost.shape
    dev = cost.device
    value = -cost.float()
    span = torch.where(tgt_valid[None, None], value.abs(), 0.0).amax(
        dim=(1, 2)).clamp(min=1.0)                          # [L]
    eps = 1e-4 * span
    prices = torch.zeros(ln, qn, device=dev)
    owner = torch.full((ln, qn), -1, dtype=torch.long, device=dev)
    rounds = torch.zeros(ln, dtype=torch.long, device=dev)
    tidx = torch.arange(tn, device=dev).expand(ln, tn)
    value_t = value.transpose(1, 2)                         # [L, T, Q]
    for it in range(max_iters + CHECK_EVERY):
        unassigned = tgt_valid & (_assigned_query(owner, tn) < 0)   # [L, T]
        active = unassigned.any(1) & (rounds < max_iters)          # [L]
        if it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        net = value_t - prices[:, None, :]                  # [L, T, Q]
        w1, best_i = net.max(dim=2)                         # first maximum
        net2 = net.scatter(2, best_i[..., None], float("-inf"))
        w2 = net2.amax(dim=2)
        w2 = torch.where(torch.isfinite(w2), w2, w1 - span[:, None])
        bid = prices.gather(1, best_i) + (w1 - w2) + eps[:, None]
        bid = torch.where(unassigned, bid, float("-inf"))
        best_bid = torch.full((ln, qn), float("-inf"), device=dev).scatter_reduce(
            1, best_i, bid, reduce="amax")
        is_top = unassigned & (bid >= best_bid.gather(1, best_i))
        winner = torch.full((ln, qn), tn, dtype=torch.long, device=dev).scatter_reduce(
            1, best_i, torch.where(is_top, tidx, tn), reduce="amin")
        q_won = (winner < tn) & active[:, None]
        owner = torch.where(q_won, winner, owner)
        prices = torch.where(q_won, best_bid, prices)
        rounds = rounds + active.long()
    assign = torch.where(tgt_valid, _assigned_query(owner, tn), -1)
    return assign[0] if single else assign


@torch.no_grad()
def hungarian_match(pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid,
                    voxel_mask, cost_class=0.2, cost_mask=0.8, cost_dice=0.8):
    """Cost assembly + auction for [..., Q, *] predictions. Returns
    [..., T] query per target (-1 for invalid targets); no gradient, as
    in the reference (matcher.py:74)."""
    cost = match_cost_matrix(pred_logits.float(), pred_masks.float(),
                             tgt_labels, tgt_masks, tgt_valid, voxel_mask,
                             cost_class, cost_mask, cost_dice)
    return auction_assign(cost, tgt_valid)
