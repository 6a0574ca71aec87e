"""MaskFormer-style segmentation head (port of
``sam3_lora_tpu/models/seg_head.py``, eval path): prompt cross-attention into
the encoded image tokens, a top-down pixel decoder (nearest upsample + add +
conv3x3 + GroupNorm(8) + relu), a conv1x1 instance head and per-query mask
logits, plus the 1-channel semantic head."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_nearest
from .layers import MLP, Conv2d, GroupNorm, LayerNorm, MultiHeadAttention, Spec


class PixelDecoder(nn.Module):
    def __init__(self, spec: Spec, num_stages: int):
        super().__init__()
        d = spec.model.d_model
        self.conv_layers = nn.ModuleList(
            Conv2d(d, d, (3, 3), spec, padding=1) for _ in range(num_stages)
        )
        self.norms = nn.ModuleList(GroupNorm(8, d, spec) for _ in range(num_stages))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats high-res -> low-res, the last one the encoder grid."""
        prev = feats[-1]
        for conv, norm, cur in zip(self.conv_layers, self.norms, feats[:-1][::-1]):
            prev = cur + resize_nearest(prev, cur.shape[-2:])
            prev = F.relu(norm(conv(prev)))
        return prev


class UniversalSegmentationHead(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        d = cfg.d_model
        self.spec = spec
        self.cross_attn_norm = LayerNorm(d, spec)
        self.cross_attend_prompt = MultiHeadAttention(d, 8, spec)
        # FPN levels after the scalp, minus the stride-14 one the encoder replaces
        stages = len(cfg.neck_scale_factors) - cfg.scalp - 1
        self.pixel_decoder = PixelDecoder(spec, stages)
        self.instance_seg_head = Conv2d(d, d, (1, 1), spec)
        self.semantic_seg_head = Conv2d(d, 1, (1, 1), spec)
        self.mask_predictor = nn.Module()
        self.mask_predictor.mask_embed = MLP(d, d, d, 3, spec)

    def forward(
        self,
        backbone_feats: List[torch.Tensor],
        encoder_hidden_states: torch.Tensor,  # (B, HW, D)
        obj_queries: torch.Tensor,            # (B, K, D)
        prompt: torch.Tensor,                 # (B, S, D)
        prompt_mask: Optional[torch.Tensor],  # (B, S) True = pad
        feat_hw: Tuple[int, int],
    ) -> Dict[str, torch.Tensor]:
        dt = self.spec.dtype
        b, _, d = encoder_hidden_states.shape
        h, w = feat_hw
        tgt2 = self.cross_attn_norm(encoder_hidden_states)
        tgt2 = self.cross_attend_prompt(tgt2, prompt, prompt, key_padding_mask=prompt_mask)
        enc = tgt2 + encoder_hidden_states
        enc_grid = enc.transpose(1, 2).reshape(b, d, h, w)
        pixel_embed = self.pixel_decoder(list(backbone_feats[:-1]) + [enc_grid])
        instance_embeds = self.instance_seg_head(pixel_embed)
        semantic_seg = self.semantic_seg_head(pixel_embed)
        mask_embed = self.mask_predictor.mask_embed(obj_queries)
        # fp32 accumulation inside the product, logits stored in the compute dtype
        pred_masks = torch.einsum("bqc,bchw->bqhw", mask_embed.to(dt), instance_embeds.to(dt))
        return {"pred_masks": pred_masks, "semantic_seg": semantic_seg}
