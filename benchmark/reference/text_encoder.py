"""CLIP-style text encoder (a copy of the port's ``models/text_encoder.py``):
token + learned positional embedding, pre-LN residual blocks under a causal
mask, a final LayerNorm, and a linear ``resizer`` to d_model. The CLIP
``text_projection`` is kept for checkpoint parity and unused."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Embedding, LayerNorm, LoRALinear, MultiHeadAttention, Spec


class MLPBlock(nn.Module):
    def __init__(self, width: int, spec: Spec):
        super().__init__()
        self.c_fc = LoRALinear(width, width * 4, spec)
        self.c_proj = LoRALinear(width * 4, width, spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, spec: Spec, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width, spec)
        self.attn = MultiHeadAttention(width, heads, spec)
        self.ln_2 = LayerNorm(width, spec)
        self.mlp = MLPBlock(width, spec)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, attn_bias=attn_bias)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(spec, cfg.text_width, cfg.text_heads)
            for _ in range(cfg.text_layers)
        )


class TextTransformer(nn.Module):
    # text_projection is read by no forward: sharded, it is gathered only by
    # the writers (utils/checkpoint.py)
    SHARDED_AT_USE = ("text_projection",)

    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.token_embedding = Embedding(cfg.text_vocab_size, cfg.text_width, spec, std=0.02)
        self.positional_embedding = spec.empty(cfg.text_context_length, cfg.text_width)
        self.transformer = Transformer(spec)
        self.ln_final = LayerNorm(cfg.text_width, spec)
        self.text_projection = spec.empty(cfg.text_width, cfg.text_proj_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids (B, L) -> tokens (B, L, width)."""
        x = self.token_embedding(token_ids)
        seq = token_ids.shape[1]
        x = x + self.positional_embedding[:seq].to(x.dtype)
        causal = torch.full((seq, seq), -1e9, device=x.device).triu(1)[None, None]
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        return self.ln_final(x)


class VETextEncoder(nn.Module):
    """Returns (pad_mask (B, L) True = pad, resized tokens (B, L, d_model))."""

    def __init__(self, spec: Spec):
        super().__init__()
        self.encoder = TextTransformer(spec)
        self.resizer = LoRALinear(spec.model.text_width, spec.model.d_model, spec)

    def forward(self, token_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return token_ids == 0, self.resizer(self.encoder(token_ids))
