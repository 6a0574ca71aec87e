"""DETR decoder (a copy of the port's ``models/decoder.py``): learned
queries and reference boxes, a presence token, text cross-attention, image
cross-attention with the boxRPB bias, iterative box refinement, and in
training DAC query doubling (a second, one-to-many copy of the queries that
skips the self-attention) and the layer dropouts.

The boxRPB bias goes to the image cross-attention as separable halves
(``dec_separable_bias``, the default: ``ops/rpb_attention.py`` builds it
chunk by chunk), or as the dense (B, heads, L, HW) tensor, the JAX package's
oracle, through the plain attention; ``box_rpb="none"`` adds no bias.

With ``dec_remat`` each layer runs under ``checkpoint`` in training (the JAX
``nn.remat`` per decoder layer).

Presence-logit clamp: the reference calls ``logits.clamp(...)`` without
assigning it, so no clamp is applied here either.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .boxes import box_cxcywh_to_xyxy, inverse_sigmoid
from .posenc import gen_sineembed_for_position
from .layers import (
    MLP, Dropout, Embedding, LayerNorm, LoRALinear, MultiHeadAttention, Spec, checkpoint,
)


class DecoderOutput(NamedTuple):
    hs: torch.Tensor               # (layers, B, Q, D) normed per-layer queries
    reference_boxes: torch.Tensor  # (layers, B, Q, 4) box input to each layer
    pred_coords: torch.Tensor      # (layers, B, Q, 4) refined boxes, cxcywh
    presence_logits: Optional[torch.Tensor]  # (layers, B, 1)
    presence_feats: Optional[torch.Tensor]   # (B, 1, D)


class BoxRPB(nn.Module):
    """Log-scale box relative-position bias, as separable halves."""

    def __init__(self, spec: Spec, heads: int):
        super().__init__()
        cfg = spec.model
        self.mode = cfg.box_rpb
        in_dim = 4 if cfg.box_rpb == "both" else 2
        self.boxRPB_embed_x = MLP(in_dim, cfg.d_model, heads, 2, spec)
        self.boxRPB_embed_y = MLP(in_dim, cfg.d_model, heads, 2, spec)

    def forward(self, reference_boxes: torch.Tensor, feat_hw: Tuple[int, int]):
        """reference_boxes (B, Q, 4) cxcywh -> dy (B, Q, H, heads), dx (B, Q, W, heads)."""
        h, w = feat_hw
        dev = reference_boxes.device
        xyxy = box_cxcywh_to_xyxy(reference_boxes)
        coords_h = torch.arange(h, dtype=torch.float32, device=dev) / h
        coords_w = torch.arange(w, dtype=torch.float32, device=dev) / w
        dy = coords_h[None, None, :, None] - xyxy[:, :, None, 1:4:2]
        dx = coords_w[None, None, :, None] - xyxy[:, :, None, 0:3:2]
        if self.mode in ("log", "both"):
            def logscale(t):
                t = t * 8.0
                return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)

            if self.mode == "log":
                dy, dx = logscale(dy), logscale(dx)
            else:
                dy = torch.cat([dy, logscale(dy)], -1)
                dx = torch.cat([dx, logscale(dx)], -1)
        return self.boxRPB_embed_y(dy), self.boxRPB_embed_x(dx)


def rpb_dense_bias(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The separable halves dy (B, Q, H, heads), dx (B, Q, W, heads) ->
    the dense bias (B, heads, Q, H*W)."""
    b, q, h, nh = dy.shape
    w = dx.shape[2]
    bias = (dy[:, :, :, None, :] + dx[:, :, None, :, :]).reshape(b, q, h * w, nh)
    return bias.permute(0, 3, 1, 2)


class DecoderLayer(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.spec = spec
        d, heads, drop = cfg.d_model, cfg.dec_heads, cfg.dec_dropout
        self.self_attn = MultiHeadAttention(d, heads, spec, dropout=drop)
        self.norm2 = LayerNorm(d, spec)
        self.ca_text = MultiHeadAttention(d, heads, spec, dropout=drop)
        self.catext_norm = LayerNorm(d, spec)
        self.cross_attn = MultiHeadAttention(d, heads, spec, dropout=drop)
        self.norm1 = LayerNorm(d, spec)
        self.linear1 = LoRALinear(d, cfg.dec_ffn_dim, spec)
        self.linear2 = LoRALinear(cfg.dec_ffn_dim, d, spec)
        self.norm3 = LayerNorm(d, spec)
        self.dropout = Dropout(drop, spec)  # each branch's and the FFN's

    def forward(self, tgt, query_pos, memory, memory_pos, memory_text, text_mask,
                cross_attn_bias, presence, dac: bool = False):
        """``cross_attn_bias``: the separable (dy, dx, grid_hw) triple, a
        dense (B, heads, L, HW) tensor, or None."""
        # with DAC the second half of the queries (one-to-many) skips the
        # self-attention; the presence token joins the first half
        n_o2o = tgt.shape[1] // 2 if dac else tgt.shape[1]
        tgt_o2o, tgt_o2m = tgt[:, :n_o2o], tgt[:, n_o2o:]
        pos_o2o = query_pos[:, :n_o2o]
        if presence is not None:
            tgt_o2o = torch.cat([presence, tgt_o2o], dim=1)
            zero = torch.zeros_like(presence)
            pos_o2o = torch.cat([zero, pos_o2o], dim=1)
            query_pos = torch.cat([zero, query_pos], dim=1)
        qk = tgt_o2o + pos_o2o
        tgt_o2o = tgt_o2o + self.dropout(self.self_attn(qk, qk, tgt_o2o))
        tgt = self.norm2(torch.cat([tgt_o2o, tgt_o2m], dim=1) if dac else tgt_o2o)
        ca = self.ca_text(tgt + query_pos, memory_text, memory_text, key_padding_mask=text_mask)
        tgt = self.catext_norm(tgt + self.dropout(ca))
        separable = isinstance(cross_attn_bias, tuple)
        ca = self.cross_attn(tgt + query_pos, memory + memory_pos, memory,
                             attn_bias=None if separable else cross_attn_bias,
                             separable_bias=cross_attn_bias if separable else None)
        tgt = self.norm1(tgt + self.dropout(ca))
        y = self.linear2(self.dropout(F.relu(self.linear1(tgt))))
        tgt = self.norm3(tgt + self.dropout(y))
        if presence is not None:
            return tgt[:, 1:], tgt[:, :1]
        return tgt, None


class TransformerDecoder(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        d, nq = cfg.d_model, cfg.num_queries
        self.spec = spec
        self.query_embed = Embedding(nq, d, spec)
        self.reference_points = Embedding(nq, 4, spec)
        self.presence_token = Embedding(1, d, spec) if cfg.presence_token else None
        self.norm = LayerNorm(d, spec)
        self.bbox_embed = MLP(d, d, 4, 3, spec, zero_init_last=True)
        self.ref_point_head = MLP(2 * d, d, d, 2, spec)
        self.rpb = BoxRPB(spec, cfg.dec_heads) if cfg.box_rpb != "none" else None
        if cfg.presence_token:
            self.presence_token_head = MLP(d, d, 1, 3, spec)
            self.presence_token_out_norm = LayerNorm(d, spec)
        self.layers = nn.ModuleList(DecoderLayer(spec) for _ in range(cfg.dec_layers))

    def forward(self, memory, memory_pos, memory_text, text_mask, feat_hw,
                apply_dac: bool = False) -> DecoderOutput:
        cfg = self.spec.model
        remat = self.training and torch.is_grad_enabled() and cfg.dec_remat
        dt = self.spec.dtype
        b, d, nq = memory.shape[0], cfg.d_model, cfg.num_queries
        tgt = self.query_embed()[None].expand(b, nq, d).to(dt)
        ref = torch.sigmoid(self.reference_points().float())[None].expand(b, nq, 4)
        if apply_dac:
            tgt, ref = torch.cat([tgt, tgt], dim=1), torch.cat([ref, ref], dim=1)
        presence = None
        if self.presence_token is not None:
            presence = self.presence_token()[None].expand(b, 1, d).to(dt)

        hs, refs, coords, pres = [], [], [], []
        pres_feats = None
        # as in the reference: the boxes recorded for the loss carry the
        # gradient along the refinement chain; the box fed to the next layer
        # is detached
        ref_grad = ref
        for layer in self.layers:
            query_pos = self.ref_point_head(gen_sineembed_for_position(ref, d))
            bias = None
            if self.rpb is not None:
                dy, dx = self.rpb(ref, feat_hw)
                if cfg.dec_separable_bias:
                    if presence is not None:
                        # the presence row attends with zero bias
                        dy = torch.cat([torch.zeros_like(dy[:, :1]), dy], dim=1)
                        dx = torch.cat([torch.zeros_like(dx[:, :1]), dx], dim=1)
                    bias = (dy, dx, feat_hw)
                else:
                    bias = rpb_dense_bias(dy, dx)
                    if presence is not None:
                        bias = torch.cat([torch.zeros_like(bias[:, :, :1]), bias], dim=2)
            args = (tgt, query_pos, memory, memory_pos, memory_text, text_mask,
                    bias, presence, apply_dac)
            tgt, presence = checkpoint(layer, layer, *args) if remat else layer(*args)
            normed = self.norm(tgt)
            delta = self.bbox_embed(normed).float()
            hs.append(normed)
            refs.append(ref_grad)
            coords.append(torch.sigmoid(delta + inverse_sigmoid(ref_grad)))
            ref_grad = torch.sigmoid(delta + inverse_sigmoid(ref))
            ref = ref_grad.detach()
            if presence is not None:
                logits = self.presence_token_head(self.presence_token_out_norm(presence))
                pres.append(logits.squeeze(-1))
                pres_feats = presence
        return DecoderOutput(
            hs=torch.stack(hs),
            reference_boxes=torch.stack(refs),
            pred_coords=torch.stack(coords),
            presence_logits=torch.stack(pres) if pres else None,
            presence_feats=pres_feats,
        )
