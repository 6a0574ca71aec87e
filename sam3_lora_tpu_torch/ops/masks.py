"""Mask ops: pairwise mask IoU and masks -> boxes (port of
``sam3_lora_tpu/ops/masks.py``).

The intersection is one ``torch.matmul`` of 0/1 floats over the flattened
pixels. It is exact on any device and in any summation order: every
partial sum is an integer under 2**24, and neither TF32 nor bf16 rounds 0
or 1.
"""

from __future__ import annotations

import torch


def mask_iou(masks1: torch.Tensor, masks2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between two stacks of binary masks.

    masks1: (N, H, W) bool/float; masks2: (M, H, W) -> (N, M) float32,
    intersection / max(union, 1)."""
    m1 = masks1.reshape(masks1.shape[0], -1).float()
    m2 = masks2.reshape(masks2.shape[0], -1).float()
    inter = m1 @ m2.T
    union = m1.sum(-1)[:, None] + m2.sum(-1)[None, :] - inter
    return inter / union.clamp(min=1.0)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Bounding xyxy boxes of binary masks (N, H, W) -> (N, 4) float32:
    inclusive-exclusive pixel coordinates [x0, y0, x1 + 1, y1 + 1]; empty
    masks give zeros."""
    n, h, w = masks.shape
    m = masks.bool()
    ys = torch.arange(h, dtype=torch.float32, device=m.device)
    xs = torch.arange(w, dtype=torch.float32, device=m.device)
    big = torch.tensor(1e9, device=m.device)
    row_any, col_any = m.any(dim=2), m.any(dim=1)  # (N, H), (N, W)
    y0 = torch.where(row_any, ys, big).amin(dim=1)
    y1 = torch.where(row_any, ys, -big).amax(dim=1)
    x0 = torch.where(col_any, xs, big).amin(dim=1)
    x1 = torch.where(col_any, xs, -big).amax(dim=1)
    boxes = torch.stack([x0, y0, x1 + 1.0, y1 + 1.0], dim=-1)
    return torch.where(m.flatten(1).any(dim=1)[:, None], boxes, 0.0)
