"""Plain scaled dot-product attention (port of the XLA form of
``sam3_lora_tpu/ops/attention.py::dot_product_attention``): fp32 scores and
softmax, an additive bias, a key-padding mask with True = padding filled
with -1e9, optional dropout on the probabilities (torch MHA semantics, the
JAX MHA's short-sequence training path), and plain einsums. q, k, v are
(B, H, L, Dh)."""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e9  # finite fill: a fully padded row gives a uniform softmax, not NaN


def make_attention_bias(
    key_padding_mask: Optional[torch.Tensor], bias: Optional[torch.Tensor]
) -> Optional[torch.Tensor]:
    """Combine an additive bias and a (B, Lk) bool padding mask into one
    fp32 bias broadcastable to (B, H, Lq, Lk)."""
    out = None if bias is None else bias.float()
    if key_padding_mask is not None:
        pad = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                          device=key_padding_mask.device)
        pad = pad.masked_fill(key_padding_mask, _NEG_INF)[:, None, None, :]
        out = pad if out is None else out + pad
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout: float = 0.0,
    rng=None,
) -> torch.Tensor:
    """``rng`` (a ``models.layers.DropoutRNG``) draws the dropout mask."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    full_bias = make_attention_bias(key_padding_mask, bias)
    if full_bias is not None:
        logits = logits + full_bias
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        keep = 1.0 - dropout
        probs = torch.where(rng.keep_mask(probs.shape, keep, probs.device), probs / keep, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, D/H)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H*Dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)
