"""Fusion (DETR) encoder and the shared encoder layer (a copy of the port's ``models/fusion_encoder.py``).

Each layer runs pre-norm self-attention (position encodings added to q/k),
cross-attention to the prompt sequence, and a relu FFN, with dropout on each
branch in training. Over the 5184 image tokens the self-attention is an
unmasked long self-attention (``numerics.attention``).

In training every layer runs under ``checkpoint`` (memory only).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout, LayerNorm, LoRALinear, MultiHeadAttention, Spec, checkpoint


class EncoderLayer(nn.Module):
    """Pre-norm self-attn -> cross-attn -> FFN."""

    def __init__(
        self,
        spec: Spec,
        d_model: int,
        heads: int,
        ffn_dim: int,
        dropout: float,
        pos_enc_at_attn: bool,
        pos_enc_at_cross_attn_keys: bool,
        pos_enc_at_cross_attn_queries: bool,
    ):
        super().__init__()
        self.spec = spec
        self.pos_enc_at_attn = pos_enc_at_attn
        self.pos_enc_at_cross_attn_keys = pos_enc_at_cross_attn_keys
        self.pos_enc_at_cross_attn_queries = pos_enc_at_cross_attn_queries
        self.norm1 = LayerNorm(d_model, spec)
        self.self_attn = MultiHeadAttention(d_model, heads, spec, dropout=dropout)
        self.norm2 = LayerNorm(d_model, spec)
        self.cross_attn_image = MultiHeadAttention(d_model, heads, spec, dropout=dropout)
        self.norm3 = LayerNorm(d_model, spec)
        self.linear1 = LoRALinear(d_model, ffn_dim, spec)
        self.linear2 = LoRALinear(ffn_dim, d_model, spec)
        self.dropout = Dropout(dropout, spec)  # the FFN's and each branch's

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
        tgt2 = self.self_attn(qk, qk, tgt2, key_padding_mask=tgt_key_padding_mask)
        tgt = tgt + self.dropout(tgt2)

        tgt2 = self.norm2(tgt)
        q = (tgt2 + query_pos
             if (self.pos_enc_at_cross_attn_queries and query_pos is not None) else tgt2)
        k = memory + pos if (self.pos_enc_at_cross_attn_keys and pos is not None) else memory
        tgt2 = self.cross_attn_image(q, k, memory, key_padding_mask=memory_key_padding_mask)
        tgt = tgt + self.dropout(tgt2)

        tgt2 = self.norm3(tgt)
        tgt2 = self.ffn(tgt2)
        # held: this mask follows linear2's frozen product, which the
        # enc_remat replay then need not run again
        return tgt + self.dropout(tgt2)

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        """linear1 -> relu -> dropout -> linear2 (the JAX ``_ffn``)."""
        return self.linear2(self.dropout(F.relu(self.linear1(x))))


class TransformerEncoderFusion(nn.Module):
    """Image tokens (B, HW, D) + their sine pos, prompt (B, S, D) + padding
    mask -> encoded memory (B, HW, D)."""

    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.spec = spec
        self.layers = nn.ModuleList(
            EncoderLayer(
                spec, cfg.d_model, cfg.enc_heads, cfg.enc_ffn_dim, cfg.enc_dropout,
                pos_enc_at_attn=True,
                pos_enc_at_cross_attn_keys=False,
                pos_enc_at_cross_attn_queries=False,
            )
            for _ in range(cfg.enc_layers)
        )

    def forward(self, src, src_pos, prompt, prompt_key_padding_mask):
        cfg = self.spec.model
        remat = self.training and torch.is_grad_enabled()  # memory only
        out = src
        for layer in self.layers:
            args = (out, prompt, src_pos, None, None, prompt_key_padding_mask)
            if remat:
                out = checkpoint(layer, layer, *args)
            else:
                out = layer(*args)
        return out
