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

``auction`` is the JAX package's approximate single-phase auction, kept on
the device for the video tier's detection-to-track association, whose
results must be the JAX ones (it may differ from the exact assignment on
near-ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, box_iou, generalized_box_iou
from ..utils.logging import to_device, to_host


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


INF = 1e30  # the JAX auction's finite infinity
AUCTION_CHECK_EVERY = 8  # auction iterations between convergence checks (host syncs)


def auction(cost: torch.Tensor, row_valid: Optional[torch.Tensor] = None,
            rel_eps: float = 2e-3, max_iters: int = 1024) -> torch.Tensor:
    """Single-phase forward auction (Bertsekas), approximate: cost (..., T,
    Q) float32, row_valid (..., T) bool -> col_of_row (..., T) int64, -1 for
    invalid rows. The JAX package's ``_auction_single`` vmapped over the
    leading dims: every unassigned valid row bids in parallel each
    iteration (Jacobi) with eps = rel_eps * the problem's value span; the
    lowest-index row wins a column among its best bids.

    All problems iterate together, and convergence is checked every
    ``AUCTION_CHECK_EVERY`` iterations (one host sync each), not after
    every one as JAX's ``while_loop`` does. Both give the JAX result: once
    no valid row of a problem is unassigned, an iteration is a no-op for
    it (no row bids, so no column is won and no price moves), and no
    problem runs past ``max_iters`` iterations, where JAX stops it."""
    if row_valid is None:
        row_valid = torch.ones(cost.shape[:-1], dtype=torch.bool, device=cost.device)
    t, q = cost.shape[-2:]
    a = (-cost.float()).reshape(-1, t, q)
    valid = row_valid.reshape(-1, t)
    a = torch.where(valid[..., None], a, 0.0)
    span = (a.amax(dim=(1, 2)) - a.amin(dim=(1, 2))).clamp(min=1e-6)
    eps = (span * rel_eps)[:, None]
    b = a.shape[0]
    rows = torch.arange(t, device=a.device).expand(b, t)
    r2c = torch.full((b, t), -1, dtype=torch.long, device=a.device)
    c2r = torch.full((b, q), -1, dtype=torch.long, device=a.device)
    p = torch.zeros((b, q), dtype=torch.float32, device=a.device)
    it = 0
    while it < max_iters and bool(((r2c < 0) & valid).any()):
        for _ in range(min(AUCTION_CHECK_EVERY, max_iters - it)):
            r2c, c2r, p = _auction_iteration(a, valid, rows, eps, r2c, c2r, p)
        it += min(AUCTION_CHECK_EVERY, max_iters - it)
    return torch.where(valid, r2c, -1).reshape(row_valid.shape)


def _auction_iteration(a, valid, rows, eps, r2c, c2r, p):
    """One Jacobi bidding round of ``auction`` over (B, T, Q) values."""
    b, t, q = a.shape
    u = (r2c < 0) & valid
    vals = a - p[:, None, :]
    v1, j1 = vals.max(dim=2)
    v2 = vals.scatter(2, j1[..., None], -INF).amax(dim=2)
    bid_eff = torch.where(u, v1 - v2 + eps, -INF)
    col_best = torch.full((b, q), -INF, device=a.device).scatter_reduce(
        1, j1, bid_eff, "amax", include_self=True)
    is_best = u & (bid_eff >= col_best.gather(1, j1))
    col_winner = torch.full((b, q), t, dtype=torch.long, device=a.device).scatter_reduce(
        1, j1, torch.where(is_best, rows, t), "amin", include_self=True)
    won_col = col_winner < t
    # evict the previous owners of the columns won this round (winners and
    # evictees are disjoint: only unassigned rows bid)
    evicted = torch.where(won_col, c2r, -1)
    evmask = torch.zeros((b, t), dtype=torch.long, device=a.device).scatter_reduce(
        1, evicted.clamp(0, t - 1), (evicted >= 0).long(), "amax", include_self=True) > 0
    row_won = u & won_col.gather(1, j1) & (col_winner.gather(1, j1) == rows)
    r2c = torch.where(row_won, j1, torch.where(evmask, -1, r2c))
    c2r = torch.where(won_col, col_winner, c2r)
    p = torch.where(won_col, p + col_best, p)
    return r2c, c2r, p


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
    both = to_host(torch.cat([cost, tgt_valid[..., None].to(cost.dtype)], dim=-1),
                   "match_cost").numpy()
    idx = solve_assignment(both[..., :-1], both[..., -1] > 0.5)
    return to_device(torch.from_numpy(idx), pred_logits.device, "match_idx")


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
