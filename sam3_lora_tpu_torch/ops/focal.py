"""Sigmoid BCE, focal and dice losses (port of ``sam3_lora_tpu/ops/focal.py``):
elementwise chains in plain PyTorch, as the JAX package left them to XLA."""

from __future__ import annotations

from typing import Optional

import torch


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy_with_logits, elementwise, numerically stable."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(
    logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0
) -> torch.Tensor:
    """Elementwise focal loss (no reduction)."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, targets)
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    num_boxes,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dice loss over (N, P) flattened masks, reduced sum / num_boxes."""
    inputs = torch.sigmoid(logits)
    numerator = 2.0 * (inputs * targets).sum(-1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    if weights is not None:
        loss = loss * weights
    return loss.sum() / num_boxes
