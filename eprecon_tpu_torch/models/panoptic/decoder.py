"""Mask2Former-style masked transformer decoder over compacted voxels
(port of eprecon_tpu/models/panoptic/decoder.py; reference
models/mask3dformer.py:202-458).

80 learned queries, 6 layers cycling over 3 voxel scales: masked
cross-attention -> self-attention -> FFN, with class / mask heads after
every layer. Attention is written out as einsum, softmax, einsum, with the
JAX module's precisions: bf16 projections, f32 logits and softmax.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from eprecon_tpu_torch.models.blocks import MLP
from eprecon_tpu_torch.models.layers import Dense, LayerNorm
from eprecon_tpu_torch.models.panoptic.position_encoding import \
    FourierPositionEncoding

NEG_INF = -1e9
BF16 = torch.bfloat16


def nearest_fine_index(coords_p: torch.Tensor, valid_p: torch.Tensor,
                       coords_fine: torch.Tensor, valid_fine: torch.Tensor,
                       chunk: int = 2048) -> torch.Tensor:
    """For each level-p voxel, the row of the nearest valid fine voxel (0
    where the level voxel is not valid): the reference's torch.cdist +
    argmin (mask3dformer.py:359-367), streamed over chunks of fine voxels
    so that the [K_p, K_fine] distances never exist at once; distances as
    |a|^2 + |b|^2 - 2ab, ties to the lowest row. The forward finds the
    same rows in O(1) per voxel (eprecon.nearest_fine_in_cell)."""
    a = coords_p.float()
    b = coords_fine.float()
    a_sq = (a * a).sum(1, keepdim=True)
    best_d = torch.full((a.shape[0],), float("inf"), device=a.device)
    best_i = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    for base in range(0, b.shape[0], chunk):
        bc, vc = b[base:base + chunk], valid_fine[base:base + chunk]
        d = a_sq + (bc * bc).sum(1)[None, :] - 2.0 * (a @ bc.T)
        d = torch.where(vc[None, :], d, float("inf"))
        cd, ci = d.min(dim=1)
        upd = cd < best_d
        best_d = torch.where(upd, cd, best_d)
        best_i = torch.where(upd, ci.to(torch.int32) + base, best_i)
    return torch.where(valid_p, best_i, 0)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with boolean masks, True = do not attend
    (reference mask3dformer.py:12-130)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.q = Dense(c, c, dtype=BF16, xavier=True)
        self.k = Dense(c, c, dtype=BF16, xavier=True)
        self.v = Dense(c, c, dtype=BF16, xavier=True)
        self.out = Dense(c, c, xavier=True)

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None,
                key_padding: Optional[torch.Tensor] = None):
        """q [Q, C]; k, v [L, C]; attn_mask bool [H, Q, L] or [Q, L];
        key_padding bool [L]."""
        c = q.shape[-1]
        h = self.h
        hd = c // h
        wq = self.q(q).reshape(-1, h, hd)
        wk = self.k(k).reshape(-1, h, hd)
        wv = self.v(v).reshape(-1, h, hd)
        logits = torch.einsum("qhd,lhd->hql", wq, wk).float() / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, NEG_INF)
        if key_padding is not None:
            logits = logits.masked_fill(key_padding[None, None, :], NEG_INF)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("hql,lhd->qhd", w, wv.float()).reshape(-1, c)
        return self.out(out)


class DecoderOutputs(NamedTuple):
    pred_logits: torch.Tensor  # [layers+1, Q, num_classes+1]
    pred_masks: torch.Tensor   # [layers+1, Q, K_fine] mask logits


class MaskedTransformerDecoder(nn.Module):
    """reference models/mask3dformer.py:202-458 for one fragment."""

    def __init__(self, num_classes: int = 20, hidden_dim: int = 48,
                 num_queries: int = 80, num_heads: int = 8,
                 dim_feedforward: int = 192, dec_layers: int = 6,
                 num_levels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = hidden_dim
        self.dec_layers, self.num_levels = dec_layers, num_levels
        self.query_feat = nn.Parameter(torch.randn(num_queries, c,
                                                   generator=generator))
        self.query_embed = nn.Parameter(torch.randn(num_queries, c,
                                                    generator=generator))
        self.level_embed = nn.Parameter(torch.randn(num_levels, c,
                                                    generator=generator))
        self.FourierPositionEncoding_0 = FourierPositionEncoding(
            c, generator=generator)
        self.decoder_norm = LayerNorm(c)
        self.class_embed = Dense(c, num_classes + 1)
        self.mask_embed = MLP(c, 4 * c, c, 3)
        for j in range(dec_layers):
            setattr(self, f"cross_{j}", MultiHeadAttention(c, num_heads))
            setattr(self, f"cross_norm_{j}", LayerNorm(c))
            setattr(self, f"self_{j}", MultiHeadAttention(c, num_heads))
            setattr(self, f"self_norm_{j}", LayerNorm(c))
            setattr(self, f"ffn1_{j}", Dense(c, dim_feedforward))
            setattr(self, f"ffn2_{j}", Dense(dim_feedforward, c))
            setattr(self, f"ffn_norm_{j}", LayerNorm(c))

    def forward(self, level_feats: Sequence[torch.Tensor],
                level_coords: Sequence[torch.Tensor],
                level_valid: Sequence[torch.Tensor],
                mask_features: torch.Tensor,
                spatial_shape: Tuple[int, int, int],
                mask_idx: Sequence[torch.Tensor]) -> DecoderOutputs:
        """level_*: per level (coarse -> fine) feats [K_p, C], fine-unit
        coords [K_p, 3], valid [K_p]; mask_features [K_fine, C];
        mask_idx: nearest fine-voxel row per level voxel
        (eprecon.nearest_fine_in_cell)."""
        dev = mask_features.device
        smin = torch.zeros(3, device=dev)
        smax = torch.tensor(spatial_shape, dtype=torch.float32, device=dev)
        src = [level_feats[p] + self.level_embed[p] for p in range(self.num_levels)]
        pos = [self.FourierPositionEncoding_0(level_coords[p].float(), smin, smax)
               for p in range(self.num_levels)]
        mask_features = mask_features.float()

        def prediction_heads(output, level):
            d = self.decoder_norm(output)
            ocls = self.class_embed(d)
            omask = torch.einsum("qc,lc->ql", self.mask_embed(d), mask_features)
            # attention mask for the next level: mask logits at each level
            # voxel's nearest fine voxel; True = do not attend
            valid = level_valid[level][None, :]
            amask = (torch.sigmoid(omask[:, mask_idx[level]]) < 0.5) | ~valid
            # un-mask queries whose mask is empty (reference :388)
            all_masked = ((~amask) & valid).sum(1) == 0
            amask = torch.where(all_masked[:, None], ~valid, amask)
            return ocls, omask, amask

        output = self.query_feat
        ocls, omask, amask = prediction_heads(output, 0)
        logits_all, masks_all = [ocls], [omask]
        for j in range(self.dec_layers):
            lvl = j % self.num_levels
            qe = self.query_embed
            att = getattr(self, f"cross_{j}")(
                output + qe, src[lvl] + pos[lvl], src[lvl], attn_mask=amask,
                key_padding=~level_valid[lvl])
            output = getattr(self, f"cross_norm_{j}")(output + att)
            att = getattr(self, f"self_{j}")(output + qe, output + qe, output)
            output = getattr(self, f"self_norm_{j}")(output + att)
            ff = getattr(self, f"ffn2_{j}")(F.relu(getattr(self, f"ffn1_{j}")(output)))
            output = getattr(self, f"ffn_norm_{j}")(output + ff)
            ocls, omask, amask = prediction_heads(output, (j + 1) % self.num_levels)
            logits_all.append(ocls)
            masks_all.append(omask)
        return DecoderOutputs(torch.stack(logits_all), torch.stack(masks_all))
