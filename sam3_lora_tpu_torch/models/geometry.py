"""Geometry (box/point/mask) prompt encoder (port of
``sam3_lora_tpu/models/geometry.py``).

Boxes live in a fixed (B, P, 4) tensor with a (B, P) True = pad mask; each is
embedded by a direct projection + ROI-align pooling + sine PE + a label
embedding. A CLS token is appended, the sequence is projected and normed,
then cross-attends to the stride-14 image tokens through ``geo_layers``
encoder layers. Output: [P box slots | Pp point slots | CLS].

With ``geo_mask_prompts`` (off in the released model) a mask prompt runs
through a ``SimpleMaskEncoder`` on the pre-normed feature grid, and its H*W
tokens (features + sine PE) are appended after the encode layers, which they
skip, with the prompt's padding broadcast over them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import box_cxcywh_to_xyxy
from ..ops.posenc import encode_boxes, encode_xy
from ..ops.sampling import grid_sample, roi_align
from .fusion_encoder import EncoderLayer
from .layers import Conv2d, Embedding, LayerNorm, LoRALinear, Spec
from .tracker import SimpleMaskEncoder


@dataclasses.dataclass
class GeoPrompt:
    """boxes (B, P, 4) normalized cxcywh; mask (B, P) True = padding; labels
    (B, P) int, 1 = positive. Points (B, Pp, 2) normalized xy, likewise. One
    mask prompt a row: mask_embeddings (B, 1, Hm, Wm) float mask scores,
    mask_mask (B, 1) True = padding, mask_labels (B, 1) int."""

    boxes: torch.Tensor
    mask: torch.Tensor
    labels: torch.Tensor
    points: Optional[torch.Tensor] = None
    points_mask: Optional[torch.Tensor] = None
    points_labels: Optional[torch.Tensor] = None
    mask_embeddings: Optional[torch.Tensor] = None
    mask_mask: Optional[torch.Tensor] = None
    mask_labels: Optional[torch.Tensor] = None

    @staticmethod
    def empty(batch: int, num_slots: int, device=None) -> "GeoPrompt":
        return GeoPrompt(
            boxes=torch.zeros((batch, num_slots, 4), device=device),
            mask=torch.ones((batch, num_slots), dtype=torch.bool, device=device),
            labels=torch.ones((batch, num_slots), dtype=torch.long, device=device),
        )


class GeometryEncoder(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        d = cfg.d_model
        self.spec = spec
        self.img_pre_norm = LayerNorm(d, spec)
        self.boxes_direct_project = LoRALinear(4, d, spec)
        self.boxes_pool_project = Conv2d(d, d, (cfg.geo_roi_size, cfg.geo_roi_size), spec)
        self.boxes_pos_enc_project = LoRALinear(d + 2, d, spec)
        self.label_embed = Embedding(2, d, spec)
        self.points_direct_project = LoRALinear(2, d, spec)
        self.points_pool_project = LoRALinear(d, d, spec)
        self.points_pos_enc_project = LoRALinear(d, d, spec)
        self.cls_embed = Embedding(1, d, spec)
        self.final_proj = LoRALinear(d, d, spec)
        self.norm = LayerNorm(d, spec)
        self.encode = nn.ModuleList(
            EncoderLayer(
                spec, d, cfg.enc_heads, cfg.enc_ffn_dim, cfg.enc_dropout,
                pos_enc_at_attn=False,
                pos_enc_at_cross_attn_keys=True,
                pos_enc_at_cross_attn_queries=False,
            )
            for _ in range(cfg.geo_layers)
        )
        self.encode_norm = LayerNorm(d, spec)
        self.mask_encoder = (
            SimpleMaskEncoder(spec, out_dim=d, in_dim=d, num_fuser_layers=cfg.geo_mask_fuser_layers)
            if cfg.geo_mask_prompts else None
        )

    def forward(
        self,
        prompt: GeoPrompt,
        img_feats: torch.Tensor,  # (B, HW, D)
        img_pos: torch.Tensor,    # (B, HW, D)
        feat_hw: Tuple[int, int],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (geo_tokens (B, P+Pp+1 [+HW], D), geo_mask (B, P+Pp+1 [+HW])
        True = pad); the HW mask tokens come with a mask prompt."""
        cfg = self.spec.model
        dt = self.spec.dtype
        d = cfg.d_model
        b, p, _ = prompt.boxes.shape
        h, w = feat_hw
        r = cfg.geo_roi_size

        feats_grid = self.img_pre_norm(img_feats).transpose(1, 2).reshape(b, d, h, w)

        boxes = prompt.boxes
        direct = self.boxes_direct_project(boxes)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
        pooled = roi_align(feats_grid.float(), box_cxcywh_to_xyxy(boxes) * scale, output_size=r)
        pooled = self.boxes_pool_project(pooled.reshape(b * p, d, r, r)).reshape(b, p, d)
        cx, cy, ww, hh = boxes.unbind(-1)
        pe = self.boxes_pos_enc_project(encode_boxes(cx, cy, ww, hh, num_pos_feats=d))
        emb = direct + pooled + pe + self.label_embed(prompt.labels.clamp(0, 1))

        if prompt.points is not None and prompt.points.shape[1] > 0:
            pts = prompt.points
            grid = (pts * 2.0 - 1.0)[:, :, None, :]  # (B, Pp, 1, 2)
            sampled = grid_sample(feats_grid.float(), grid)[..., 0].transpose(1, 2)
            ex, ey = encode_xy(pts[..., 0], pts[..., 1], num_pos_feats=d)
            p_emb = (
                self.points_direct_project(pts)
                + self.points_pool_project(sampled)
                + self.points_pos_enc_project(torch.cat([ex, ey], -1))
                + self.label_embed(prompt.points_labels.clamp(0, 1))
            )
            point_mask = prompt.points_mask
        else:
            p_emb = emb.new_zeros((b, 0, d))
            point_mask = prompt.mask.new_ones((b, 0))

        cls = self.cls_embed()[None].expand(b, 1, d)
        seq = torch.cat([emb, p_emb, cls.to(emb.dtype)], dim=1)
        mask = torch.cat([prompt.mask, point_mask, prompt.mask.new_zeros((b, 1))], dim=1)
        # zero padded slots so nothing leaks through the residuals
        seq = seq.masked_fill(mask[..., None], 0.0)
        seq = self.norm(self.final_proj(seq))
        for layer in self.encode:
            seq = layer(seq, img_feats, None, img_pos, mask, None)
        seq = self.encode_norm(seq).to(dt)
        if self.mask_encoder is not None and prompt.mask_embeddings is not None:
            enc = self.mask_encoder(feats_grid.to(dt), prompt.mask_embeddings.float(),
                                    skip_mask_sigmoid=True)
            mtok = (enc["vision_features"] + enc["vision_pos_enc"]).reshape(b, d, -1).transpose(1, 2)
            mpad = prompt.mask_mask.expand(b, mtok.shape[1])  # one mask a row
            seq = torch.cat([seq, mtok.to(dt).masked_fill(mpad[..., None], 0.0)], dim=1)
            mask = torch.cat([mask, mpad], dim=1)
        return seq, mask
