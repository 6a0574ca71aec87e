"""Feature-map resizing matching ``sam3_lora_tpu/ops/interpolate.py``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """x: (..., H, W) -> (..., size), half-pixel bilinear computed in fp32:
    without antialias the JAX package's ``resize_bilinear``, with it
    ``jax.image.resize(..., "bilinear")`` (the two differ only where a side
    shrinks; the edge taps are renormalized, which for an upscale is
    torch's clamp of the sample position)."""
    lead = x.shape[:-2]
    y = F.interpolate(
        x.float().reshape(-1, 1, *x.shape[-2:]), size=tuple(size),
        mode="bilinear", align_corners=False, antialias=antialias,
    )
    return y.reshape(*lead, *size).to(x.dtype)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W) -> (..., size) with torch's index rule
    src = floor(dst * in / out)."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = size
    ys = torch.floor(torch.arange(h_out, device=x.device) * (h_in / h_out)).long()
    xs = torch.floor(torch.arange(w_out, device=x.device) * (w_in / w_out)).long()
    return x[..., ys, :][..., :, xs]
