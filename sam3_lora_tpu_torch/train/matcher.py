"""Matchers of the training step (port of ``sam3_lora_tpu/train/matcher.py``):
the focal-flavour Hungarian cost, the exact one-to-one assignment, and the
DAC one-to-many top-k.

The JAX package solves the assignment on the TPU (an auction by default, an
exact Jonker-Volgenant as an option) so the step never leaves the device.
Here the costs are computed on the device, and every problem of a step (all
layers, o2o and aux o2m, every image) comes to the host in one transfer and
is solved exactly there with ``scipy.optimize.linear_sum_assignment``, the
reference's own solver: a solver on the GPU would need a host sync per
iteration.

An assignment is a (..., T) int64 ``query_of_target``, -1 for padded targets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, box_iou, generalized_box_iou


def matching_cost(
    pred_logits: torch.Tensor,  # (..., Q, 1)
    pred_boxes: torch.Tensor,   # (..., Q, 4) cxcywh
    tgt_boxes: torch.Tensor,    # (..., T, 4) cxcywh (padded)
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Reference BinaryHungarianMatcherV2 cost, focal flavour -> (..., T, Q),
    rows = targets."""
    s = pred_logits[..., 0].float()
    prob = torch.sigmoid(s)
    cclass = (-alpha * (1 - prob) ** gamma * F.logsigmoid(s)
              + (1 - alpha) * prob ** gamma * F.logsigmoid(-s))
    pred_boxes, tgt_boxes = pred_boxes.float(), tgt_boxes.float()
    cbbox = (pred_boxes[..., :, None, :] - tgt_boxes[..., None, :, :]).abs().sum(-1)
    cgiou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    c = cost_bbox * cbbox + cost_class * cclass[..., :, None] + cost_giou * cgiou
    return c.transpose(-1, -2)


def solve_assignment(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment of the valid rows of each (T, Q) problem:
    cost (..., T, Q), valid (..., T) -> (..., T) int64, -1 for invalid rows."""
    from scipy.optimize import linear_sum_assignment

    t, q = cost.shape[-2:]
    flat_c, flat_v = cost.reshape(-1, t, q), valid.reshape(-1, t)
    out = np.full(flat_v.shape, -1, np.int64)
    for i in range(flat_c.shape[0]):
        rows = np.flatnonzero(flat_v[i])
        if rows.size:
            r, c = linear_sum_assignment(flat_c[i][rows])
            out[i, rows[r]] = c
    return out.reshape(valid.shape)


def hungarian_match(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    tgt_boxes: torch.Tensor,
    tgt_valid: torch.Tensor,
    **cost_kw,
) -> torch.Tensor:
    """One-to-one matching -> query_of_target (..., T) int64 on the inputs'
    device, -1 for invalid targets. The costs and the validity travel to the
    host together, in one copy."""
    cost = matching_cost(pred_logits, pred_boxes, tgt_boxes, **cost_kw).detach()
    both = torch.cat([cost, tgt_valid[..., None].to(cost.dtype)], dim=-1).cpu().numpy()
    idx = solve_assignment(both[..., :-1], both[..., -1] > 0.5)
    return torch.from_numpy(idx).to(pred_logits.device)


def one_to_many_match(
    pred_logits: torch.Tensor,  # (B, Q, 1)
    pred_boxes: torch.Tensor,   # (B, Q, 4)
    tgt_boxes: torch.Tensor,    # (B, T, 4)
    tgt_valid: torch.Tensor,    # (B, T)
    alpha: float = 0.3,
    threshold: float = 0.4,
    topk: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAC greedy o2m matching: for each target the top-k queries by
    C = alpha*prob + (1-alpha)*iou, valid where C exceeds the threshold ->
    (query_idx (B, T, K) int64, valid (B, T, K) bool)."""
    with torch.no_grad():
        prob = torch.sigmoid(pred_logits[..., 0].float())
        iou, _ = box_iou(box_cxcywh_to_xyxy(pred_boxes.float()),
                         box_cxcywh_to_xyxy(tgt_boxes.float()))
        c = (alpha * prob[..., :, None] + (1 - alpha) * iou).transpose(-1, -2)  # (B, T, Q)
        vals, idx = torch.topk(c, topk, dim=-1)
        return idx, (vals > threshold) & tgt_valid[..., None]
