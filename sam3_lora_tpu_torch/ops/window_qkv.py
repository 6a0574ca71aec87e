"""Window attention straight off the qkv projection (W-qkv): port of
``sam3_lora_tpu/ops/window_qkv.py`` (``_call_fwd``, ``_call_bwd``).

``window_attention_qkv`` and ``window_attention_rope_qkv`` take the projection
output (N, L, 3*dim), dim = heads * head_dim, [q | k | v] channels, and return
the (N, L, dim) attention output in merge-heads order; the backward writes one
dqkv of the input's shape. The TPU kernels existed to spare the relayouts
around the projection; the port's CUDA kernels (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``) read q, k and v as strided views of that tensor and
write that layout, so W-qkv is the same launch as K1, counted on its own
entries; its plain version is ``attention_kernel.attention_packed_plain`` on
the three column blocks. ``QKV_NATIVE`` is read from the JAX package's
``SAM3_WINDOW_QKV_NATIVE`` (default off); the ViT takes this route when it is
on.
"""

from __future__ import annotations

import os

import torch

from . import window_attention as wa
from .attention_kernel import attend_qkv

QKV_NATIVE = os.environ.get("SAM3_WINDOW_QKV_NATIVE", "0") == "1"


def qkv_native_ok(heads: int, head_dim: int, x: torch.Tensor) -> bool:
    """Whether the ViT takes this route: the JAX gate, ``QKV_NATIVE`` and
    the packed chain's."""
    return QKV_NATIVE and wa.packed_native_ok(heads, head_dim, x)


def window_attention_qkv(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """(N, L, 3*dim) -> (N, L, dim), no RoPE."""
    return attend_qkv(window_attention_qkv, qkv, scale, qkv.shape[-1] // (3 * heads))


def window_attention_rope_qkv(qkv: torch.Tensor, heads: int, scale: float,
                              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The same with rotate-half RoPE on q and k: channels unrotated;
    cos/sin (L, head_dim//2)."""
    return attend_qkv(window_attention_rope_qkv, qkv, scale, qkv.shape[-1] // (3 * heads),
                      cos, sin)


for _entry in (window_attention_qkv, window_attention_rope_qkv):
    _entry.launches = 0
    _entry.bwd_launches = 0
