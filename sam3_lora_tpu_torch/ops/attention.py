"""Scaled dot-product attention (port of
``sam3_lora_tpu/ops/attention.py::dot_product_attention``). q, k, v are
(B, H, L, Dh).

``impl="xla"`` (the default) is the plain expression: fp32 scores and
softmax, an additive bias, a key-padding mask with True = padding filled with
-1e9, optional dropout on the probabilities (torch MHA semantics, the JAX
MHA's short-sequence training path), and plain einsums. ``impl="window"`` is
the ViT's whole-window attention, bias- and mask-free, with optional RoPE
(``rope_cos``/``rope_sin``, q and k unrotated): CUDA tensors go to
``window_attention[_rope]`` (W-p or W-g), CPU tensors to the plain
expression after ``apply_rope_half``, as the JAX function falls back off the
TPU."""

from __future__ import annotations

from typing import Optional

import torch

from .rope import apply_rope_half
from .window_attention import window_attention, window_attention_rope

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
    impl: str = "xla",
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``rng`` (a ``models.layers.DropoutRNG``) draws the dropout mask."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if impl == "window":
        if bias is not None or key_padding_mask is not None or dropout > 0.0:
            raise ValueError("impl='window' takes no bias, mask or dropout")
        if q.is_cuda:
            if rope_cos is not None:
                return window_attention_rope(q, k, v, scale, rope_cos, rope_sin)
            return window_attention(q, k, v, scale)
        if rope_cos is not None:
            q, k = apply_rope_half(q, rope_cos, rope_sin), apply_rope_half(k, rope_cos, rope_sin)
    elif impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    elif rope_cos is not None:
        raise ValueError("only impl='window' takes rope tables")
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
