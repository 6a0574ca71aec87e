"""Windowed ViT attention (K1, K1-bwd): port of
``sam3_lora_tpu/ops/window_attention.py::window_attention_rope_packed``.

Bias-free, non-causal attention inside each window, over packed
(N, L, P*dh) operands (P heads of width dh side by side in the last dim),
with rotate-half RoPE on q and k from (L, dh/2) tables. On a CUDA tensor it
launches ``csrc/attention_fwd.cu`` (and, for a gradient,
``csrc/attention_bwd.cu``); on a CPU tensor it runs the plain versions.
"""

from __future__ import annotations

import torch

from .attention_kernel import attend, attend_qkv, attention_packed_plain


def window_attention_rope_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """q/k unrotated, in rotate-half layout per head; cos/sin (L, dh//2), so
    dh = 2 * cos.shape[-1]. Rows of q/k/v may be strided views."""
    return attend(window_attention_rope_packed, q, k, v, scale, 2 * cos.shape[-1], cos, sin)


def window_attention_rope_packed_qkv(
    qkv: torch.Tensor, scale: float, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """The same over the ViT's whole (N, L, 3*P*dh) qkv projection output,
    whose gradient then comes back as one tensor; counted on
    ``window_attention_rope_packed``."""
    return attend_qkv(window_attention_rope_packed, qkv, scale, 2 * cos.shape[-1], cos, sin)


window_attention_rope_packed.launches = 0
window_attention_rope_packed.bwd_launches = 0


def window_attention_rope_packed_plain(q, k, v, scale, cos, sin):
    """Plain PyTorch version of ``window_attention_rope_packed``."""
    return attention_packed_plain(q, k, v, scale, 2 * cos.shape[-1], cos, sin)
