"""Fusion (DETR) encoder and the shared encoder layer (port of
``sam3_lora_tpu/models/fusion_encoder.py``, eval path).

Each layer runs pre-norm self-attention (position encodings added to q/k),
cross-attention to the prompt sequence, and a relu FFN. Over the 5184 image
tokens the self-attention is an unmasked long self-attention, which
``MultiHeadAttention`` sends to ``long_attention_packed``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm, LoRALinear, MultiHeadAttention, Spec


class EncoderLayer(nn.Module):
    """Pre-norm self-attn -> cross-attn -> FFN."""

    def __init__(
        self,
        spec: Spec,
        d_model: int,
        heads: int,
        ffn_dim: int,
        pos_enc_at_attn: bool,
        pos_enc_at_cross_attn_keys: bool,
        pos_enc_at_cross_attn_queries: bool,
    ):
        super().__init__()
        self.pos_enc_at_attn = pos_enc_at_attn
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.pos_enc_at_cross_attn_queries = pos_enc_at_cross_attn_queries
        self.norm1 = LayerNorm(d_model, spec)
        self.self_attn = MultiHeadAttention(d_model, heads, spec)
        self.norm2 = LayerNorm(d_model, spec)
        self.cross_attn_image = MultiHeadAttention(d_model, heads, spec)
        self.norm3 = LayerNorm(d_model, spec)
        self.linear1 = LoRALinear(d_model, ffn_dim, spec)
        self.linear2 = LoRALinear(ffn_dim, d_model, spec)

    def forward(
        self,
        tgt: torch.Tensor,      # (B, L, D)
        memory: torch.Tensor,   # (B, S, D)
        query_pos: Optional[torch.Tensor] = None,
        pos: Optional[torch.Tensor] = None,
        tgt_key_padding_mask: Optional[torch.Tensor] = None,
        memory_key_padding_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        tgt2 = self.norm1(tgt)
        qk = tgt2 + query_pos if (self.pos_enc_at_attn and query_pos is not None) else tgt2
        tgt = tgt + self.self_attn(qk, qk, tgt2, key_padding_mask=tgt_key_padding_mask)

        tgt2 = self.norm2(tgt)
        q = (tgt2 + query_pos
             if (self.pos_enc_at_cross_attn_queries and query_pos is not None) else tgt2)
        k = memory + pos if (self.pos_enc_at_cross_attn_keys and pos is not None) else memory
        tgt = tgt + self.cross_attn_image(q, k, memory, key_padding_mask=memory_key_padding_mask)

        tgt2 = self.linear2(F.relu(self.linear1(self.norm3(tgt))))
        return tgt + tgt2


class TransformerEncoderFusion(nn.Module):
    """Image tokens (B, HW, D) + their sine pos, prompt (B, S, D) + padding
    mask -> encoded memory (B, HW, D)."""

    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.layers = nn.ModuleList(
            EncoderLayer(
                spec, cfg.d_model, cfg.enc_heads, cfg.enc_ffn_dim,
                pos_enc_at_attn=True,
                pos_enc_at_cross_attn_keys=False,
                pos_enc_at_cross_attn_queries=False,
            )
            for _ in range(cfg.enc_layers)
        )

    def forward(self, src, src_pos, prompt, prompt_key_padding_mask):
        out = src
        for layer in self.layers:
            out = layer(out, prompt, src_pos, None, None, prompt_key_padding_mask)
        return out
