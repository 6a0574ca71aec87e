"""Detection-to-track association on the device, with static shapes (port
of ``sam3_lora_tpu/ops/association.py``).

* tracks match one-to-one by a max-IoU assignment (``train/matcher.py::
  auction``, the JAX package's approximate auction, so that the matches
  are its own); a track is matched iff its assigned detection reaches
  ``iou_threshold_trk``;
* a detection is new iff it reaches ``iou_threshold`` with no track and
  its score is at least ``new_det_thresh``;
* ``det_to_trk`` is the (N, M) "IoU >= threshold" incidence.

Validity masks stand in for dynamic lengths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..train.matcher import auction
from .masks import mask_iou


class Association(NamedTuple):
    new_det: torch.Tensor              # (N,) bool: detections starting new tracks
    unmatched_trk: torch.Tensor        # (M,) bool: tracks with no detection
    det_to_trk: torch.Tensor           # (N, M) bool incidence (IoU >= thr)
    matched_det_score: torch.Tensor    # (M,) score of the assigned detection (0 if none)
    matched_det_score_iou: torch.Tensor  # (M,) score * IoU of the assignment
    iou: torch.Tensor                  # (N, M)


def associate_det_trk(
    det_masks: torch.Tensor,      # (N, H, W) bool / logits > 0
    trk_masks: torch.Tensor,      # (M, H, W)
    det_valid: Optional[torch.Tensor] = None,   # (N,) bool
    trk_valid: Optional[torch.Tensor] = None,   # (M,) bool
    det_scores: Optional[torch.Tensor] = None,  # (N,)
    iou_threshold: float = 0.5,
    iou_threshold_trk: float = 0.5,
    new_det_thresh: float = 0.0,
) -> Association:
    n, m = det_masks.shape[0], trk_masks.shape[0]
    dev = det_masks.device
    det_valid = torch.ones((n,), dtype=torch.bool, device=dev) if det_valid is None else det_valid
    trk_valid = torch.ones((m,), dtype=torch.bool, device=dev) if trk_valid is None else trk_valid
    det_scores = (torch.ones((n,), dtype=torch.float32, device=dev) if det_scores is None
                  else det_scores.float())

    iou = mask_iou(det_masks > 0, trk_masks > 0)
    iou = torch.where(det_valid[:, None] & trk_valid[None, :], iou, 0.0)

    # one-to-one assignment maximizing IoU with tracks as rows (each track
    # gets at most one detection)
    trk_to_det = auction(1.0 - iou.T, row_valid=trk_valid)
    safe = trk_to_det.clamp(0, n - 1)
    assigned_iou = torch.where(trk_to_det >= 0, iou[safe, torch.arange(m, device=dev)], 0.0)
    matched_trk = assigned_iou >= iou_threshold_trk
    unmatched_trk = trk_valid & ~matched_trk

    det_to_trk = (iou >= iou_threshold) & det_valid[:, None] & trk_valid[None, :]
    new_det = det_valid & ~det_to_trk.any(dim=1) & (det_scores >= new_det_thresh)

    matched_score = torch.where(trk_to_det >= 0, det_scores[safe], 0.0)
    return Association(
        new_det=new_det,
        unmatched_trk=unmatched_trk,
        det_to_trk=det_to_trk,
        matched_det_score=matched_score,
        matched_det_score_iou=matched_score * assigned_iou,
        iou=iou,
    )
