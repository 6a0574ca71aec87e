"""2D axial rotary position embeddings (port of ``sam3_lora_tpu/ops/rope.py``).

``compute_axial_freqs`` and ``rope_half_perm`` are host-side numpy tables,
unchanged. ``apply_rope_half`` rotates q/k whose channels are in rotate-half
layout (all even pair-members, then all odd ones); the weight bridge folds
that column permutation into the ViT qkv projection once, at load.
``apply_rope`` rotates adjacent channel pairs (2i, 2i+1), as
``torch.view_as_complex`` pairs them: the tracker's memory attention uses
it, with unpermuted projections.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_axial_freqs(
    dim: int,
    end_x: int,
    end_y: int,
    theta: float = 10000.0,
    scale_pos: float = 1.0,
    offset: float = 0.0,
) -> np.ndarray:
    """Angle table for 2D axial RoPE -> (end_x*end_y, dim//2) float32: the
    first dim//4 channels rotate with x, the last dim//4 with y; tokens are
    row-major (t_x = t % end_x, t_y = t // end_x)."""
    freqs = 1.0 / (
        theta ** (np.arange(0, dim, 4, dtype=np.float32)[: dim // 4] / dim)
    )
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x = (t % end_x) * scale_pos + offset
    t_y = np.floor(t / end_x) * scale_pos + offset
    return np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], axis=-1)


def rope_cos_sin(angles) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.as_tensor(angles, dtype=torch.float32)
    return torch.cos(a), torch.sin(a)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the adjacent channel pairs (2i, 2i+1) of x (..., L, D) by
    (L, D//2) angle tables, in fp32, cast back to x's dtype."""
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1).reshape(x.shape).to(x.dtype)


def rope_half_perm(head_dim: int) -> np.ndarray:
    """Channel permutation from interleaved pairs (2i, 2i+1) to rotate-half
    layout (i, i + D/2): ``new[j] = old[perm[j]]``."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., L, D) in rotate-half layout by (L, D//2) angle tables,
    in fp32, cast back to x's dtype."""
    h = x.shape[-1] // 2
    xf = x.float()
    xe, xo = xf[..., :h], xf[..., h:]
    out = torch.cat([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope_half_inv(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The transpose of ``apply_rope_half`` (rotation by the negated angles):
    carries a gradient of rotated q/k back to the unrotated input."""
    h = x.shape[-1] // 2
    xf = x.float()
    xe, xo = xf[..., :h], xf[..., h:]
    out = torch.cat([xe * cos + xo * sin, xo * cos - xe * sin], dim=-1)
    return out.to(x.dtype)
