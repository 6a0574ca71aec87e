"""Windowed ViT attention: port of ``sam3_lora_tpu/ops/window_attention.py``.

Bias-free, non-causal attention inside each 576-token window, with or
without rotate-half RoPE on q and k from (L, dh/2) tables, forward and
backward. The JAX package has one Pallas kernel family per layout; here every
entry launches the same CUDA kernels (``csrc/attention_fwd.cu`` and, for a
gradient, ``csrc/attention_bwd.cu``), which read each operand in place through
its strides, and each entry counts its own launches:

* K1 ``window_attention_rope_packed`` and K1' ``window_attention_packed``:
  packed (N, L, P*dh) operands (P heads side by side), the ViT's packed
  chain. The ViT hands K1 strided views of its qkv projection output.
* W-g ``window_attention_grouped`` / ``window_attention_rope_grouped``
  (``_window_pallas``): head-grouped (B, H, L, D), read as N = B sequences
  of P = H heads with the tensor's own head stride.
* W-p ``window_attention_pair_packed`` / ``window_attention_rope_pair_packed``
  (``_window_pallas_packed``): the same (B, H, L, D) tensors as the JAX
  ``_pack`` lays them out, (B*H/2, L, 2D): N = B*H/2 head pairs of P = 2. The
  pair view is a reshape; when a tensor's batch stride is not H times its
  head stride (a view of the qkv projection output, say) the reshape has to
  copy it, as the JAX ``_pack`` relayout does.
* ``window_attention`` / ``window_attention_rope`` on (B, H, L, D) route to
  W-p or W-g as the JAX wrappers do (``_use_packed``), by ``_PACKED``;
  ``packed_native_ok`` is the ViT's gate for the packed chain.

Flags, read from the JAX package's environment variables as module
attributes (``chip_smoke.py`` sets them): ``_PACKED`` (``SAM3_WINDOW_PACKED``,
default on) and ``FUSE_ROPE`` (``SAM3_WINDOW_FUSE_ROPE``, default on: the
ViT's grouped chain hands RoPE to the kernel, else rotates q and k first).

On a CUDA tensor an entry launches the kernel (or raises); on a CPU tensor it
runs the plain version, ``attention_kernel.attention_plain`` on the entry's
(N, P, L, dh) view (``attention_packed_plain`` on a packed layout). The JAX
kernels default to a clamp softmax exp(min(s, 70)); the port's is the exact
max shift, equal while the row max stays below 70.
"""

from __future__ import annotations

import os

import torch

from .attention_kernel import attend, attend_qkv, attention_packed_plain

_PACKED = os.environ.get("SAM3_WINDOW_PACKED", "1") == "1"
FUSE_ROPE = os.environ.get("SAM3_WINDOW_FUSE_ROPE", "1") == "1"
# Tests set this to take the card's routes on the CPU, through the entries'
# plain versions, and to drop the D % 64 gate (the JAX flag of this name runs
# the Pallas kernels in interpret mode and relaxes the same gates).
_FORCE_INTERPRET = False


def window_attention_rope_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """K1. q/k unrotated, in rotate-half layout per head; cos/sin (L, dh//2),
    so dh = 2 * cos.shape[-1]. Rows of q/k/v may be strided views."""
    return attend(window_attention_rope_packed, q, k, v, scale, 2 * cos.shape[-1], cos, sin)


def window_attention_rope_packed_qkv(
    qkv: torch.Tensor, scale: float, cos: torch.Tensor, sin: torch.Tensor,
) -> torch.Tensor:
    """K1 over the ViT's whole (N, L, 3*P*dh) qkv projection output (q, k, v
    read as strided views, P heads each), whose gradient then comes back as
    one tensor; counted on ``window_attention_rope_packed``."""
    return attend_qkv(window_attention_rope_packed, qkv, scale, 2 * cos.shape[-1], cos, sin)


def window_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """K1': head-pair-packed (N, L, 2D) operands, N = B*H/2, heads (2i, 2i+1)
    side by side, no RoPE (the ViT with ``vit_use_rope=False``)."""
    return attend(window_attention_packed, q, k, v, scale, q.shape[-1] // 2)


def window_attention_packed_qkv(qkv: torch.Tensor, scale: float, head_dim: int) -> torch.Tensor:
    """K1' over the ViT's whole qkv projection output, as
    ``window_attention_rope_packed_qkv``; counted on
    ``window_attention_packed``."""
    return attend_qkv(window_attention_packed, qkv, scale, head_dim)


def _pairs(t: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) -> the (B*H/2, 2, L, D) head pairs of the JAX ``_pack``:
    a view when the strides allow, else a copy (the relayout)."""
    b, h, l, d = t.shape
    return t.reshape(b * (h // 2), 2, l, d)


def window_attention_grouped(q, k, v, scale: float) -> torch.Tensor:
    """W-g without RoPE: (B, H, L, D) q, k, v of any strides -> (B, H, L, D)."""
    return attend(window_attention_grouped, q, k, v, scale, None)


def window_attention_rope_grouped(q, k, v, scale: float, cos, sin) -> torch.Tensor:
    """W-g with RoPE fused: q/k unrotated; cos/sin (L, D//2)."""
    return attend(window_attention_rope_grouped, q, k, v, scale, None, cos, sin)


def window_attention_pair_packed(q, k, v, scale: float) -> torch.Tensor:
    """W-p without RoPE: (B, H, L, D), H even -> (B, H, L, D)."""
    out = attend(window_attention_pair_packed, *(_pairs(t) for t in (q, k, v)), scale, None)
    return out.reshape(q.shape)


def window_attention_rope_pair_packed(q, k, v, scale: float, cos, sin) -> torch.Tensor:
    """W-p with RoPE fused."""
    out = attend(window_attention_rope_pair_packed, *(_pairs(t) for t in (q, k, v)), scale,
                 None, cos, sin)
    return out.reshape(q.shape)


def _use_packed(q: torch.Tensor) -> bool:
    """The JAX gate: an even head count and D % 64 == 0."""
    _, h, _, d = q.shape
    return _PACKED and h % 2 == 0 and (d % 64 == 0 or _FORCE_INTERPRET)


def packed_native_ok(heads: int, head_dim: int, x: torch.Tensor) -> bool:
    """Whether the ViT takes the packed chain (K1, K1'): the JAX gate, with
    its TPU backend read as a CUDA tensor."""
    return (_PACKED and heads % 2 == 0 and (head_dim % 64 == 0 or _FORCE_INTERPRET)
            and (x.is_cuda or _FORCE_INTERPRET))


def window_attention(q, k, v, scale: float) -> torch.Tensor:
    """Window attention over (B, H, L, D): W-p or W-g, as ``_use_packed``."""
    entry = window_attention_pair_packed if _use_packed(q) else window_attention_grouped
    return entry(q, k, v, scale)


def window_attention_rope(q, k, v, scale: float, cos, sin) -> torch.Tensor:
    """``window_attention`` with RoPE fused in the kernel: q/k unrotated, in
    rotate-half layout; cos/sin (L, D//2)."""
    entry = (window_attention_rope_pair_packed if _use_packed(q)
             else window_attention_rope_grouped)
    return entry(q, k, v, scale, cos, sin)


ENTRIES = (
    window_attention_rope_packed, window_attention_packed,
    window_attention_grouped, window_attention_rope_grouped,
    window_attention_pair_packed, window_attention_rope_pair_packed,
)
for _entry in ENTRIES:
    _entry.launches = 0
    _entry.bwd_launches = 0


def window_attention_rope_packed_plain(q, k, v, scale, cos, sin):
    """Plain PyTorch version of ``window_attention_rope_packed``."""
    return attention_packed_plain(q, k, v, scale, 2 * cos.shape[-1], cos, sin)
