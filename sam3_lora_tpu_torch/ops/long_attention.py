"""Long-sequence attention (K2, K3 and their backward K2/3-bwd): port of
``sam3_lora_tpu/ops/long_attention.py::long_attention_rope_packed`` (the 4
global ViT blocks) and ``long_attention_packed`` (the fusion-encoder
self-attention).

Unmasked, bias-free, non-causal attention over packed (N, L, P*head_dim)
operands. The kernel streams K/V tiles and masks the ragged tail itself, so
any L is taken (the JAX kernel padded 5184 to 5248 and zeroed the pad
columns). On a CUDA tensor each entry point launches ``csrc/attention_fwd.cu``
(and, for a gradient, ``csrc/attention_bwd.cu``); on a CPU tensor it runs the
plain versions.
"""

from __future__ import annotations

import torch

from .attention_kernel import attend, attend_qkv, attention_packed_plain


def long_attention_rope_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    head_dim: int, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """q/k unrotated, in rotate-half layout; cos/sin (L, head_dim//2)."""
    return attend(long_attention_rope_packed, q, k, v, scale, head_dim, cos, sin)


def long_attention_rope_packed_qkv(
    qkv: torch.Tensor, scale: float, head_dim: int, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """The same over the ViT's whole (N, L, 3*P*head_dim) qkv projection
    output, whose gradient then comes back as one tensor; counted on
    ``long_attention_rope_packed``."""
    return attend_qkv(long_attention_rope_packed, qkv, scale, head_dim, cos, sin)


def long_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    head_dim: int,
) -> torch.Tensor:
    return attend(long_attention_packed, q, k, v, scale, head_dim)


def long_attention_packed_qkv(qkv: torch.Tensor, scale: float, head_dim: int) -> torch.Tensor:
    """The same over a whole (N, L, 3*P*head_dim) qkv projection output (the
    ViT's global blocks with ``vit_use_rope=False``); counted on
    ``long_attention_packed``."""
    return attend_qkv(long_attention_packed, qkv, scale, head_dim)


long_attention_rope_packed.launches = 0
long_attention_rope_packed.bwd_launches = 0
long_attention_packed.launches = 0
long_attention_packed.bwd_launches = 0


def long_attention_rope_packed_plain(q, k, v, scale, head_dim, cos, sin):
    """Plain PyTorch version of ``long_attention_rope_packed``."""
    return attention_packed_plain(q, k, v, scale, head_dim, cos, sin)


def long_attention_packed_plain(q, k, v, scale, head_dim):
    """Plain PyTorch version of ``long_attention_packed``."""
    return attention_packed_plain(q, k, v, scale, head_dim)
