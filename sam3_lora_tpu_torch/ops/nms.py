"""Greedy NMS over a pairwise IoU matrix (port of ``sam3_lora_tpu/ops/nms.py``).

The rows go in the order of ``argsort(-score)``, stable, as the JAX
package's: tied scores keep their input order. The recurrence is
sequential in that order: a row that survives suppresses every later row
whose IoU with it exceeds the threshold. JAX runs it as a device
``fori_loop``; here the thresholded, sorted IoU matrix (N x N bool, 40 KB at
N = 200) crosses to the host once and numpy visits the rows: on the card,
faster than the same loop kept on the device, three small launches a row
(``chip_smoke.nms_device_loop``; ``PERF.md`` §5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .masks import mask_iou


def greedy_order(
    iou: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's operands: ``order`` (the rows by descending score,
    stable; an invalid row scores -inf), ``sup`` (N, N) bool, where row i
    would suppress a later row j (IoU > threshold, j after i in that order),
    and ``alive``, the rows that start unsuppressed (the valid ones), all in
    that order."""
    n = scores.shape[0]
    s = scores.float()
    if valid is not None:
        s = torch.where(valid, s, -torch.inf)
    order = torch.argsort(-s, stable=True)
    sup = (iou[order][:, order] > iou_threshold).triu(diagonal=1)
    alive = (torch.ones((n,), dtype=torch.bool, device=s.device) if valid is None
             else valid[order].bool())
    return order, sup, alive


def generic_nms_mask(
    iou: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy NMS given a pairwise IoU matrix.

    iou: (N, N); scores: (N,); valid: optional (N,) bool (an invalid row
    neither survives nor suppresses). Returns keep: (N,) bool, in the input
    order, on the scores' device."""
    order, sup, alive = greedy_order(iou, scores, iou_threshold, valid)
    sup_h, keep_h = sup.cpu().numpy(), alive.cpu().numpy().copy()
    for i in range(len(keep_h)):
        if keep_h[i]:
            keep_h &= ~sup_h[i]
    keep = torch.zeros_like(alive)
    keep[order] = torch.from_numpy(keep_h).to(alive.device)
    return keep


def nms_masks(
    masks: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mask NMS: pairwise mask IoU, then greedy suppression.

    masks: (N, H, W) binary; scores: (N,). Returns the keep mask (N,) bool."""
    return generic_nms_mask(mask_iou(masks, masks), scores, iou_threshold, valid=valid)
