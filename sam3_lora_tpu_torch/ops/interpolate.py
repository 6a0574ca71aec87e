"""Feature-map resizing matching ``sam3_lora_tpu/ops/interpolate.py``, and
PIL's uint8 bilinear resize (``resize_pil_bilinear``), which the JAX
package's serving path runs on the host for images and masks."""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import to_device


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


# PIL's fixed-point resampling (Pillow's Resample.c, 8 bits a channel): the
# weights are integers with PRECISION_BITS fractional bits, each pass rounds
# and clips its sums to uint8
PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=64)
def pil_bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL ``BILINEAR``'s taps for one axis of ``in_size`` -> ``out_size``:
    (index (out, ksize) int64, weight (out, ksize) int32). Output pixel ``o``
    is ``sum_k weight[o, k] * in[index[o, k]]`` before the pass's rounding;
    taps past a pixel's window have weight 0 (and a valid index). The
    arithmetic is ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` in
    float64, the order of their operations kept; the arrays are read-only."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = fs  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    x = xmin[:, None] + taps[None, :]
    w = np.maximum(1.0 - np.abs(((x - center[:, None]) + 0.5) * (1.0 / fs)), 0.0)
    w[taps[None, :] >= xmax[:, None]] = 0.0
    total = np.zeros(out_size)
    for k in range(ksize):  # summed tap by tap, as the C loop sums them
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = w * float(1 << PRECISION_BITS)
    weight = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)).astype(np.int32)
    index = np.minimum(x, in_size - 1)
    index.setflags(write=False)
    weight.setflags(write=False)
    return index, weight


@functools.lru_cache(maxsize=64)
def _taps_on(in_size: int, out_size: int, device: torch.device):
    index, weight = pil_bilinear_taps(in_size, out_size)
    return (to_device(torch.tensor(index), device, "resize_taps"),
            to_device(torch.tensor(weight), device, "resize_taps"))


def _pil_pass(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """One of PIL's passes along ``dim`` of a uint8 tensor: the taps'
    weighted sum in int32 (below 2**31: weights sum to about 2**22, pixels
    are below 2**8), plus a half, shifted down and clipped to uint8."""
    index, weight = _taps_on(x.shape[dim], out_size, x.device)
    bcast = [1] * x.ndim
    bcast[dim] = out_size
    acc = None
    for k in range(index.shape[1]):
        term = x.index_select(dim, index[:, k]).to(torch.int32) * weight[:, k].view(bcast)
        acc = term + (1 << (PRECISION_BITS - 1)) if acc is None else acc.add_(term)
    return (acc >> PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resize_pil_bilinear(x: torch.Tensor, size: Tuple[int, int], dims: Tuple[int, int] = (-2, -1)
                        ) -> torch.Tensor:
    """uint8 ``x`` resized to ``size`` (height, width) on its device, PIL's
    ``Image.resize(..., BILINEAR)`` pixel for pixel: ``dims`` name the
    height and width axes (an HWC image: (0, 1)); every other axis (the
    channels, a batch of masks) is resampled on its own. The width pass runs
    first, then the height pass, each rounded to uint8; an axis whose size
    does not change is not resampled."""
    if x.dtype != torch.uint8:
        raise TypeError(f"resize_pil_bilinear takes uint8, got {x.dtype}")
    hdim, wdim = (d % x.ndim for d in dims)
    if x.shape[wdim] != size[1]:
        x = _pil_pass(x, wdim, size[1])
    if x.shape[hdim] != size[0]:
        x = _pil_pass(x, hdim, size[0])
    return x
