"""Semantic-segmentation criterion, detection<->track association losses and
the PointRend point-sampled mask loss of the video tier (port of
``sam3_lora_tpu/train/video_losses.py``), in fp32 as plain functions on
tensors.

* :func:`semantic_seg_loss`: instance masks merged into one semantic target
  (resized to the prediction grid as ``jax.image.resize(..., "bilinear")``
  does, with antialias when it shrinks), BCE or focal plus dice, the
  optional presence head gating per-image losses to frames with
  foreground, and mIoU.
* :func:`det2trk_assoc_loss`, :func:`tracking_by_detection_assoc_loss`:
  softmax CE over the association columns with -1 labels contributing 0.
  A detection's label is the FIRST track that carries its object id (JAX's
  ``argmax`` over a bool tensor), taken as the smallest matching index.
* :func:`point_sample`, :func:`get_uncertain_point_coords_with_randomness`,
  :func:`point_sampled_mask_loss`: focal + dice at points drawn where the
  logits are least certain. The draw (two uniform tensors, from an optional
  ``torch.Generator``) is apart from the deterministic selection
  (:func:`uncertain_point_coords`), so that a caller can pass the same
  draws to both packages or to both devices. The importance points are the
  top uncertainties with the lower index first on ties, as
  ``jax.lax.top_k`` orders them: a stable descending sort, since
  ``torch.topk`` promises no order among equal values (on tied
  uncertainties its order differs from JAX's even on the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.focal import sigmoid_bce, sigmoid_focal_loss
from ..ops.interpolate import resize_bilinear
from ..ops.sampling import grid_sample

__all__ = [
    "semantic_seg_loss",
    "det2trk_assoc_loss",
    "tracking_by_detection_assoc_loss",
    "point_sample",
    "draw_point_uniforms",
    "uncertain_point_coords",
    "get_uncertain_point_coords_with_randomness",
    "point_sampled_mask_loss",
]


def _dice_per_image(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Unreduced dice over (B, P) flattened masks."""
    p = torch.sigmoid(logits)
    num = 2.0 * (p * targets).sum(-1)
    den = p.sum(-1) + targets.sum(-1)
    return 1.0 - (num + 1.0) / (den + 1.0)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax CE with -1 labels contributing 0 (the reference's
    ignore_index=-1, without its mean over the kept rows)."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.clamp(min=0).long()
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(labels >= 0, ce, torch.zeros_like(ce))


def _first_true(same: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N) bool -> (index of the first True, any True); the index is
    meaningless where there is none."""
    n = same.shape[-1]
    idx = torch.arange(n, device=same.device)
    return torch.where(same, idx, n).amin(dim=-1), same.any(dim=-1)


def semantic_seg_loss(
    semantic_logits: torch.Tensor,       # (B, 1, h, w)
    instance_masks: torch.Tensor,        # (B, T, H, W) float {0,1}
    mask_valid: torch.Tensor,            # (B, T) bool
    presence_logit: Optional[torch.Tensor] = None,  # (B,) or (B, 1)
    focal: bool = False,
    focal_alpha: float = 0.6,
    focal_gamma: float = 1.6,
    presence_loss: bool = True,
) -> Dict[str, torch.Tensor]:
    logits = semantic_logits[:, 0].float()             # (B, h, w)
    hw = tuple(logits.shape[-2:])
    inst = torch.where(mask_valid[..., None, None], instance_masks.float(), 0.0)
    sem = inst.amax(dim=1)                             # (B, H, W)
    target = (resize_bilinear(sem, hw, antialias=True) > 0.5).float()

    b = logits.shape[0]
    flat_l = logits.reshape(b, -1)
    flat_t = target.reshape(b, -1)
    if focal:
        per_px = sigmoid_focal_loss(flat_l, flat_t, alpha=focal_alpha, gamma=focal_gamma)
    else:
        per_px = sigmoid_bce(flat_l, flat_t)
    per_img = per_px.mean(dim=1)                       # (B,)
    d = _dice_per_image(flat_l, flat_t)                # (B,)

    pred = torch.sigmoid(flat_l) > 0.5
    tgt = flat_t > 0.5
    inter = (pred & tgt).sum(dim=1)
    union = (pred | tgt).sum(dim=1)
    miou = torch.where(union > 0, inter / union.clamp(min=1), 1.0).mean()

    out: Dict[str, torch.Tensor] = {}
    if presence_logit is not None:
        pl = presence_logit.reshape(b).float()
        present = flat_t.bool().any(dim=1)
        pt = present.float()
        if presence_loss:
            out["loss_semantic_presence"] = sigmoid_bce(pl, pt).mean()
            out["presence_acc"] = ((torch.sigmoid(pl) > 0.5) == present).float().mean()
        else:
            zero = torch.zeros((), device=logits.device)
            out["loss_semantic_presence"] = zero
            out["presence_acc"] = zero
        nb = pt.sum()
        per_img = (per_img * pt).sum() / (nb + 1e-6)
        d = (d * pt).sum() / (nb + 1e-6)
    else:
        per_img = per_img.mean()
        d = d.mean()

    out["loss_semantic_seg"] = per_img
    out["loss_semantic_dice"] = d
    out["miou_semantic_seg"] = miou
    return out


def _same_object(ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
    """(B, Na), (B, Nb) ids (-1 unmatched) -> (B, Na, Nb) bool: both matched
    and to the same object."""
    return ((ids_a >= 0)[:, :, None] & (ids_b >= 0)[:, None, :]
            & (ids_a[:, :, None] == ids_b[:, None, :]))


def det2trk_assoc_loss(
    assoc_logits: torch.Tensor,        # (B, Q_det, Q_trk + 2)
    matched_obj_ids_det: torch.Tensor,  # (B, Q_det) int, -1 = unmatched
    matched_obj_ids_trk: torch.Tensor,  # (B, Q_trk) int, -1 = unmatched
    num_boxes,
    pred_logits: Optional[torch.Tensor] = None,  # (B, Q_det) for FP labels
    is_exhaustive: Optional[torch.Tensor] = None,  # (B,) bool
    use_fp_loss: bool = False,
    fp_loss_on_exhaustive_only: bool = True,
    treat_fp_as_new_obj: bool = False,
) -> Dict[str, torch.Tensor]:
    b, q_det, cols = assoc_logits.shape
    q_trk = cols - 2
    det_m = matched_obj_ids_det >= 0
    trk_m = matched_obj_ids_trk >= 0
    same = _same_object(matched_obj_ids_det, matched_obj_ids_trk)  # (B, Q_det, Q_trk)
    # label a): matched track index (the first, as JAX's argmax)
    trk_label, has_trk = _first_true(same)
    labels = torch.where(has_trk, trk_label, -1)
    # label b): new object
    labels = torch.where(det_m & ~has_trk, q_trk, labels)
    # label c): false positive
    if use_fp_loss and pred_logits is not None:
        fp = ~det_m & (pred_logits > 0)
        if treat_fp_as_new_obj:
            labels = torch.where(fp, q_trk, labels)
        else:
            if fp_loss_on_exhaustive_only and is_exhaustive is not None:
                fp = fp & is_exhaustive[:, None]
            labels = torch.where(fp, q_trk + 1, labels)

    ce = _masked_ce(assoc_logits.float(), labels)      # (B, Q_det)
    ce = ce * trk_m.any(dim=-1, keepdim=True).float()
    return {"loss_det2trk_assoc": ce.sum() / (b * num_boxes)}


def tracking_by_detection_assoc_loss(
    assoc_logits: torch.Tensor,         # (B, Q_det+1, Q_trk+1)
    matched_obj_ids_det: torch.Tensor,  # (B, Q_det)
    prev_trk_object_ids: torch.Tensor,  # (B, Q_trk)
    num_boxes,
) -> Dict[str, torch.Tensor]:
    b, qd1, qt1 = assoc_logits.shape
    q_det, q_trk = qd1 - 1, qt1 - 1
    logits = assoc_logits.float()
    det_m = matched_obj_ids_det >= 0
    trk_m = prev_trk_object_ids >= 0
    frame_valid = trk_m.any(dim=-1, keepdim=True).float()
    same = _same_object(matched_obj_ids_det, prev_trk_object_ids)  # (B, Q_det, Q_trk)

    # det -> trk: matched track index, else "new object" column Q_trk
    first, has = _first_true(same)
    d_lab = torch.where(has, first, -1)
    d_lab = torch.where(det_m & ~has, q_trk, d_lab)
    d_ce = _masked_ce(logits[:, :-1], d_lab) * frame_valid
    out = {"loss_det2trk_assoc": d_ce.sum() / (b * num_boxes)}

    # trk -> det: matched det index, else "occluded" column Q_det
    first_t, has_t = _first_true(same.transpose(1, 2))  # (B, Q_trk)
    t_lab = torch.where(has_t, first_t, -1)
    t_lab = torch.where(trk_m & ~has_t, q_det, t_lab)
    t_ce = _masked_ce(logits.transpose(1, 2)[:, :-1], t_lab) * frame_valid
    out["loss_trk2det_assoc"] = t_ce.sum() / (b * num_boxes)
    return out


# ---------------------------------------------------------------------------
# PointRend-style point-sampled mask loss (sam3/train/loss/mask_sampling.py)
# ---------------------------------------------------------------------------


def point_sample(logits: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (N, C, H, W) at (N, P, 2) coords in [0,1]x[0,1] (x, y)
    -> (N, C, P)."""
    grid = 2.0 * coords[:, :, None, :] - 1.0           # (N, P, 1, 2) in [-1,1]
    return grid_sample(logits, grid)[..., 0]


def draw_point_uniforms(
    n: int,
    num_points: int,
    oversample_ratio: int = 3,
    importance_sample_ratio: float = 0.75,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of the point selection: (N, num_points *
    oversample_ratio, 2) candidates and (N, n_rand, 2) uniform points (JAX
    draws them from the two halves of its key), from ``generator`` on its
    device, returned on ``device``."""
    n_sampled = num_points * oversample_ratio
    n_rand = num_points - int(num_points * importance_sample_ratio)
    at = generator.device if generator is not None else device
    device = at if device is None else device
    cand = torch.rand((n, n_sampled, 2), generator=generator, device=at)
    rand = torch.rand((n, n_rand, 2), generator=generator, device=at)
    return cand.to(device), rand.to(device)


def uncertain_point_coords(
    logits: torch.Tensor,        # (N, 1, H, W)
    cand: torch.Tensor,          # (N, n_sampled, 2)
    rand: torch.Tensor,          # (N, n_rand, 2)
    num_points: int,
    importance_sample_ratio: float = 0.75,
) -> torch.Tensor:
    """(N, num_points, 2) in [0,1]^2: the ``num_points *
    importance_sample_ratio`` candidates of least |logit| (lower index first
    on ties), then the uniform points."""
    n_imp = int(num_points * importance_sample_ratio)
    uncert = -point_sample(logits, cand)[:, 0].abs()   # (N, n_sampled)
    idx = torch.sort(uncert, dim=-1, descending=True, stable=True).indices[:, :n_imp]
    imp = cand.gather(1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([imp, rand], dim=1) if rand.shape[1] else imp


def get_uncertain_point_coords_with_randomness(
    logits: torch.Tensor,        # (N, 1, H, W)
    num_points: int,
    oversample_ratio: int = 3,
    importance_sample_ratio: float = 0.75,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(N, num_points, 2) in [0,1]^2: importance-sampled where |logit| is
    small (uncertain) plus a uniform remainder (PointRend)."""
    cand, rand = draw_point_uniforms(logits.shape[0], num_points, oversample_ratio,
                                     importance_sample_ratio, generator, logits.device)
    return uncertain_point_coords(logits, cand, rand, num_points, importance_sample_ratio)


def point_sampled_mask_loss(
    pred_logits: torch.Tensor,   # (N, h, w) predicted mask logits
    gt_masks: torch.Tensor,      # (N, H, W) float {0,1}
    num_boxes,
    generator: Optional[torch.Generator] = None,
    num_points: int = 12544,
    oversample_ratio: int = 3,
    importance_sample_ratio: float = 0.75,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Focal + dice at PointRend-sampled points instead of full-resolution
    upsampling (the reference Masks loss's point-sampled variant): an (N, P)
    gather in place of (N, 1008, 1008) upsampled logits. ``draws`` (as
    :func:`draw_point_uniforms` returns them) replaces the draw from
    ``generator``; the coordinates carry no gradient."""
    p = pred_logits[:, None].float()                    # (N, 1, h, w)
    with torch.no_grad():
        if draws is None:
            draws = draw_point_uniforms(p.shape[0], num_points, oversample_ratio,
                                        importance_sample_ratio, generator, p.device)
        coords = uncertain_point_coords(p, *draws, num_points, importance_sample_ratio)
    pred_pts = point_sample(p, coords)[:, 0]            # (N, P)
    gt_pts = point_sample(gt_masks[:, None].float(), coords)[:, 0]
    gt_pts = (gt_pts > 0.5).float()
    focal = sigmoid_focal_loss(pred_pts, gt_pts, alpha=focal_alpha, gamma=focal_gamma).mean(dim=-1)
    dice = _dice_per_image(pred_pts, gt_pts)
    return {"loss_mask": focal.sum() / num_boxes, "loss_dice": dice.sum() / num_boxes}
