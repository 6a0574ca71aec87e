"""Dot-product scoring head (port of ``sam3_lora_tpu/models/scoring.py``):
MLP(prompt) -> masked mean-pool -> proj; queries -> proj; scaled dot
product, clamped to +-score_clamp."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .layers import MLP, LoRALinear, Spec


def masked_mean_pool(x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, D), pad_mask (B, S) True = pad -> (B, D)."""
    if pad_mask is None:
        return x.mean(dim=1)
    valid = (~pad_mask).to(x.dtype)[..., None]
    return (x * valid).sum(dim=1) / valid.sum(dim=1).clamp(min=1.0)


class DotProductScoring(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        d = cfg.d_model
        self.d, self.clamp = d, cfg.score_clamp
        # dropout 0.1 on the hidden layer in training, as in the JAX head
        self.prompt_mlp = MLP(d, cfg.score_mlp_hidden, d, 2, spec, dropout=0.1,
                              residual=True, out_norm=True)
        self.prompt_proj = LoRALinear(d, d, spec)
        self.hs_proj = LoRALinear(d, d, spec)

    def forward(self, hs, prompt, prompt_mask) -> torch.Tensor:
        """hs (layers, B, Q, D) -> scores (layers, B, Q, 1) fp32."""
        pooled = self.prompt_proj(masked_mean_pool(self.prompt_mlp(prompt), prompt_mask))
        proj_hs = self.hs_proj(hs)
        scores = torch.einsum("...bqd,bd->...bq", proj_hs.float(), pooled.float())[..., None]
        scores = scores * (1.0 / math.sqrt(self.d))
        return scores.clamp(-self.clamp, self.clamp)
