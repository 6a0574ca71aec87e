"""Sine position encodings (a copy of the port's ``ops/posenc.py``)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def _dim_t(num_pos_feats: int, temperature: float, device=None) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """stack(sin(x[..., 0::2]), cos(x[..., 1::2])) flattened on the last dim."""
    s = torch.sin(x[..., 0::2])
    c = torch.cos(x[..., 1::2])
    return torch.stack([s, c], dim=-1).reshape(*x.shape[:-1], s.shape[-1] + c.shape[-1])


def sine_pos_grid(
    h: int, w: int, num_pos_feats: int = 256, temperature: float = 10000.0,
    normalize: bool = True, scale: float = TWO_PI, device=None,
) -> torch.Tensor:
    """2D sine position encoding grid -> (num_pos_feats, H, W) float32
    (``num_pos_feats`` is the total, split evenly between y and x)."""
    npf = num_pos_feats // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = _dim_t(npf, temperature, device)
    pos_y = _interleave_sin_cos(y[:, None] / dim_t)  # (H, npf)
    pos_x = _interleave_sin_cos(x[:, None] / dim_t)  # (W, npf)
    pos = torch.cat(
        [pos_y[:, None, :].expand(h, w, npf), pos_x[None, :, :].expand(h, w, npf)], dim=-1
    )
    return pos.permute(2, 0, 1)


def encode_xy(x: torch.Tensor, y: torch.Tensor, num_pos_feats: int = 256,
              temperature: float = 10000.0, scale: float = TWO_PI):
    """Normalized point coords -> (pos_x, pos_y), each (..., num_pos_feats//2)."""
    dim_t = _dim_t(num_pos_feats // 2, temperature, x.device)
    pos_x = _interleave_sin_cos((x * scale)[..., None] / dim_t)
    pos_y = _interleave_sin_cos((y * scale)[..., None] / dim_t)
    return pos_x, pos_y


def encode_boxes(cx, cy, w, h, num_pos_feats: int = 256) -> torch.Tensor:
    """(pos_y | pos_x | h | w) box encoding -> (..., num_pos_feats + 2)."""
    pos_x, pos_y = encode_xy(cx, cy, num_pos_feats)
    return torch.cat([pos_y, pos_x, h[..., None], w[..., None]], dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor, num_feats: int = 256) -> torch.Tensor:
    """DETR conditional-query sine embedding: (..., 2|4) normalized coords ->
    (..., num_feats * pos.shape[-1] / 2), coordinates in (y, x, w, h) order."""
    dim_t = _dim_t(num_feats // 2, 10000.0, pos.device)
    order = [1, 0] if pos.shape[-1] == 2 else [1, 0, 2, 3]
    parts = [_interleave_sin_cos((pos[..., j] * TWO_PI)[..., None] / dim_t) for j in order]
    return torch.cat(parts, dim=-1)


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """1D sine PE of the tracker's temporal embedding: (...,) positions ->
    (..., dim), the [sin | cos] halves."""
    pe_dim = dim // 2
    dim_t = _dim_t(pe_dim, temperature, pos.device)
    x = pos.float()[..., None] / dim_t
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
