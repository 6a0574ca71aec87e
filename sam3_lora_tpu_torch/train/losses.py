"""SAM3 training losses (port of ``sam3_lora_tpu/train/losses.py``), over the
static-shape outputs of ``Sam3Image`` with targets:

* boxes: L1 + diagonal GIoU over matched pairs / num_boxes;
* IABCEMdetr: IoU-aware BCE with soft positive targets
  t = p^alpha * IoU^(1-alpha), pos_weight 10, focal-weighted negatives,
  weak (non-exhaustive) negative masking, presence focal loss;
* masks: focal(0.25, 2) + dice on matched pairs;
* summed over the main and per-layer aux outputs, plus the DAC o2m branch at
  ``o2m_weight``.

Every per-term value is returned under the JAX package's key (suffix
``_aux_{i}`` for aux layers, ``_o2m`` for the o2m branch) beside
``core_loss``.

Under a process group. The JAX step sees the whole global batch, so each
term's denominator counts the global batch: ``num_boxes``, the row count of
the presence loss and the kept entries of ``loss_ce`` (and the F1 metric's
counts). A rank here sees its own rows, so ``compute_losses`` sums those
counts over the group (one ``all_reduce`` of a small vector a call) and
divides each by the group's size N: a rank's loss is its rows' sum over
1/N of the global denominator, the mean of the ranks' losses is the global
batch's loss, and the mean of their gradients (``Trainer``'s all-reduce) is
its gradient. Without a group the counts are the batch's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.sam3_image import Targets
from ..ops.boxes import box_cxcywh_to_xyxy, fast_diag_box_iou, fast_diag_generalized_box_iou
from ..ops.focal import sigmoid_bce, sigmoid_focal_loss
from ..ops.interpolate import resize_bilinear


@dataclass(frozen=True)
class LossConfig:
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    weight_ce: float = 20.0
    weight_presence: float = 20.0
    weight_mask: float = 200.0
    weight_dice: float = 10.0
    pos_weight: float = 10.0
    alpha: float = 0.25      # IABCEM soft-target mixing + mask focal alpha
    gamma: float = 2.0       # negative down-weighting + mask focal gamma
    presence_alpha: float = 0.5
    presence_gamma: float = 0.0
    o2m_weight: float = 2.0
    # local | global | none. JAX's "global" is the pmean of the count over a
    # mesh axis; here every count is the group's already, so "global" and
    # "local" are the same normalization, with or without a group
    normalization: str = "local"
    compute_aux: bool = True


def _group_sum(v: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``v`` summed over the process group (one ``all_reduce``), and the
    group's size; ``(v, 1)`` without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return v, 1
    v = v.clone()
    dist.all_reduce(v)
    return v, dist.get_world_size()


def _num_boxes(valid_sum: torch.Tensor, n: int, cfg: LossConfig) -> torch.Tensor:
    """The box-term denominator from the group's count of valid targets
    (clamped to 1, as JAX clamps the global count) over the group's size."""
    if cfg.normalization in ("local", "global"):
        return valid_sum.clamp(min=1.0) / n
    if cfg.normalization == "none":
        return torch.ones((), device=valid_sum.device)
    raise ValueError(f"unknown loss normalization {cfg.normalization!r}")


@torch.no_grad()
def _ce_counts(pred_logits, targets: Targets, idx, pair_valid) -> torch.Tensor:
    """(4,) float: the entries ``iabce_loss`` keeps, and the F1 metric's
    true positives, false positives and false negatives."""
    q = pred_logits.shape[1]
    onehot = F.one_hot(idx.clamp(0, q - 1), q).float() * pair_valid.float()[..., None]
    target_classes = onehot.sum(tuple(range(1, idx.ndim))).clamp(0.0, 1.0)
    keep_mask = ~((~targets.is_exhaustive)[:, None] & (target_classes < 0.5))
    pred_pos = torch.sigmoid(pred_logits[..., 0].float()) > 0.5
    pos = target_classes > 0.5
    return torch.stack([keep_mask.sum(), (pred_pos & pos).sum(), (pred_pos & ~pos).sum(),
                        (~pred_pos & pos).sum()]).float()


def _gather_q(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, Q, ...), idx (B, ...) int -> x[b, idx[b]] with idx clipped."""
    b = x.shape[0]
    flat = idx.reshape(b, -1).clamp(0, x.shape[1] - 1)
    rows = torch.arange(b, device=x.device)[:, None]
    return x[rows, flat].reshape(*idx.shape, *x.shape[2:])


def _broadcast_targets(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    while t.ndim < like.ndim:
        t = t[..., None, :]
    return t.expand(like.shape)


def boxes_loss(pred_boxes, pred_xyxy, targets: Targets, idx, pair_valid, num_boxes):
    """L1 + diagonal GIoU over matched pairs. idx/pair_valid: (B, ...pairs)."""
    src = _gather_q(pred_boxes, idx)
    src_xyxy = _gather_q(pred_xyxy, idx)
    tb = _broadcast_targets(targets.boxes, src)
    tbx = _broadcast_targets(box_cxcywh_to_xyxy(targets.boxes), src_xyxy)
    w = pair_valid.float()
    l1 = ((src - tb).abs().sum(-1) * w).sum() / num_boxes
    giou = ((1.0 - fast_diag_generalized_box_iou(src_xyxy, tbx)) * w).sum() / num_boxes
    return {"loss_bbox": l1, "loss_giou": giou}


def iabce_loss(
    pred_logits,          # (B, Q, 1)
    pred_xyxy,            # (B, Q, 4)
    targets: Targets,
    idx,                  # (B, T) o2o or (B, T, K) o2m
    pair_valid,           # same shape as idx
    num_boxes,
    cfg: LossConfig,
    counts: torch.Tensor,  # (4,) _ce_counts summed over the group
    rows: torch.Tensor,    # the presence loss's row count over the group's size
    n: int,                # the group's size
    presence_logits: Optional[torch.Tensor] = None,  # (B, 1)
):
    q = pred_logits.shape[1]
    s = pred_logits[..., 0].float()
    prob = torch.sigmoid(s)

    # matched info scattered into per-query maps
    onehot = F.one_hot(idx.clamp(0, q - 1), q).float() * pair_valid.float()[..., None]
    pair_axes = tuple(range(1, idx.ndim))
    target_classes = onehot.sum(pair_axes).clamp(0.0, 1.0)  # (B, Q)

    # soft positive targets t = p^a * iou^(1-a), at least 0.01, no gradient
    with torch.no_grad():
        src_xyxy = _gather_q(pred_xyxy.float(), idx)
        tbx = _broadcast_targets(box_cxcywh_to_xyxy(targets.boxes), src_xyxy)
        iou = fast_diag_box_iou(src_xyxy, tbx)
        prob_pair = _gather_q(prob[..., None], idx)[..., 0]
        t = (prob_pair ** cfg.alpha * iou ** (1.0 - cfg.alpha)).clamp(min=0.01)
        t_map = (onehot * t[..., None]).amax(pair_axes)  # max over duplicate matches
        positive_tc = torch.where(target_classes > 0, t_map, 0.0)

    loss_bce = sigmoid_bce(s, positive_tc) * target_classes * cfg.pos_weight
    loss_bce = loss_bce + sigmoid_bce(s, target_classes) * (1.0 - target_classes) * prob ** cfg.gamma

    presence_loss = torch.zeros((), device=s.device)
    if presence_logits is not None:
        visible = targets.valid & (targets.boxes[..., 2] > 0) & (targets.boxes[..., 3] > 0)
        keep = (visible.sum(-1, keepdim=True) != 0).float()  # (B, 1)
        loss_bce = loss_bce * keep
        pl = sigmoid_focal_loss(presence_logits.float(), keep,
                                alpha=cfg.presence_alpha, gamma=cfg.presence_gamma)
        presence_loss = pl.mean(-1).sum() / rows

    # weak negatives: no negative supervision for non-exhaustive queries
    keep_mask = ~((~targets.is_exhaustive)[:, None] & (target_classes < 0.5))
    loss_bce = loss_bce * keep_mask.float()
    loss_ce = loss_bce.sum() / ((counts[0] + 1e-6) / n)

    tp, fp, fn = counts[1], counts[2], counts[3]  # binary F1 over the group, a metric
    f1 = 2 * tp / (2 * tp + fp + fn).clamp(min=1)
    return {"loss_ce": loss_ce, "presence_loss": presence_loss, "ce_f1": f1}


def masks_loss(pred_masks, targets: Targets, pair_valid, num_boxes, cfg: LossConfig):
    """Focal + dice over matched pairs. pred_masks (B, ...pairs, Hm, Wm)
    logits. The ground truth keeps its (B, T, 1, H, W) shape over the o2m K
    axis and broadcasts, never expanded over K."""
    if targets.masks is None:
        z = torch.zeros((), device=pred_masks.device)
        return {"loss_mask": z, "loss_dice": z}
    gt = targets.masks
    while gt.ndim < pred_masks.ndim:
        gt = gt.unsqueeze(2)
    pred = pred_masks.float()
    if pred.shape[-2:] != gt.shape[-2:]:
        pred = resize_bilinear(pred, tuple(gt.shape[-2:]))
    mv = targets.mask_valid
    while mv.ndim < pair_valid.ndim:
        mv = mv.unsqueeze(-1)
    w = (pair_valid & mv).float()
    gt = gt.float()
    hw = (-2, -1)
    fl = sigmoid_focal_loss(pred, gt, cfg.alpha, cfg.gamma)
    loss_mask = (fl.mean(hw) * w).sum() / num_boxes
    inputs = torch.sigmoid(pred)
    numer = 2.0 * (inputs * gt).sum(hw)
    denom = inputs.sum(hw) + gt.sum(hw)  # the gt sum broadcasts over K
    loss_dice = ((1.0 - (numer + 1.0) / (denom + 1.0)) * w).sum() / num_boxes
    return {"loss_mask": loss_mask, "loss_dice": loss_dice}


def compute_losses(
    out: Dict[str, Any], targets: Targets, cfg: LossConfig = LossConfig()
) -> Dict[str, torch.Tensor]:
    """The full training loss over the main, aux and o2m outputs of
    ``Sam3Image`` with targets: ``core_loss`` plus every per-term value.
    The batch-dependent counts are the group's (module docstring)."""
    layers = out["pred_logits"].shape[0]
    has_o2m = "pred_logits_o2m" in out
    main_layers = [li for li in range(layers) if li == layers - 1 or cfg.compute_aux]

    def pairs(li):  # (logits, xyxy, idx, pair_valid) of the o2o and the o2m branch
        idx = out["indices"][li]
        yield "", out["pred_logits"][li], idx, (idx >= 0) & targets.valid
        if has_o2m:
            yield ("_o2m", out["pred_logits_o2m"][li], out["o2m_indices"][li],
                   out["o2m_valid"][li] & targets.valid[..., None])

    # every count a denominator needs, summed over the group at once
    with torch.no_grad():
        local = [targets.valid.sum().float().reshape(1),
                 torch.full((1,), float(targets.valid.shape[0]), device=targets.valid.device)]
        local += [_ce_counts(logits, targets, idx, pv)
                  for li in main_layers for _, logits, idx, pv in pairs(li)]
        sums, n = _group_sum(torch.cat(local))
    num_boxes = _num_boxes(sums[0], n, cfg)
    rows = sums[1] / n
    site_counts = iter(sums[2:].reshape(-1, 4))

    losses: Dict[str, torch.Tensor] = {}
    core = torch.zeros((), device=num_boxes.device)
    for li in main_layers:
        is_main = li == layers - 1
        suffix = "" if is_main else f"_aux_{li}"
        (_, _, idx, pv), *o2m = pairs(li)
        presence = out["presence_logit_dec"][li] if out.get("presence_logit_dec") is not None else None
        lb = boxes_loss(out["pred_boxes"][li], out["pred_boxes_xyxy"][li], targets, idx, pv,
                        num_boxes)
        lc = iabce_loss(out["pred_logits"][li], out["pred_boxes_xyxy"][li], targets, idx, pv,
                        num_boxes, cfg, next(site_counts), rows, n, presence_logits=presence)
        term = (cfg.weight_bbox * lb["loss_bbox"] + cfg.weight_giou * lb["loss_giou"]
                + cfg.weight_ce * lc["loss_ce"] + cfg.weight_presence * lc["presence_loss"])
        if is_main and "pred_masks_matched" in out:
            lm = masks_loss(out["pred_masks_matched"], targets, pv, num_boxes, cfg)
            term = term + cfg.weight_mask * lm["loss_mask"] + cfg.weight_dice * lm["loss_dice"]
            losses.update({f"{k}{suffix}": v for k, v in lm.items()})
        core = core + term
        losses.update({f"{k}{suffix}": v for k, v in {**lb, **lc}.items()})

        if o2m:
            (_, _, o2m_idx, o2m_pv), = o2m
            lb2 = boxes_loss(out["pred_boxes_o2m"][li], out["pred_boxes_xyxy_o2m"][li],
                             targets, o2m_idx, o2m_pv, num_boxes)
            lc2 = iabce_loss(out["pred_logits_o2m"][li], out["pred_boxes_xyxy_o2m"][li],
                             targets, o2m_idx, o2m_pv, num_boxes, cfg, next(site_counts), rows, n)
            term2 = (cfg.weight_bbox * lb2["loss_bbox"] + cfg.weight_giou * lb2["loss_giou"]
                     + cfg.weight_ce * lc2["loss_ce"])
            if is_main and "pred_masks_o2m_matched" in out:
                lm2 = masks_loss(out["pred_masks_o2m_matched"], targets, o2m_pv, num_boxes, cfg)
                term2 = (term2 + cfg.weight_mask * lm2["loss_mask"]
                         + cfg.weight_dice * lm2["loss_dice"])
                losses.update({f"{k}{suffix}_o2m": v for k, v in lm2.items()})
            core = core + cfg.o2m_weight * term2
            losses.update({f"{k}{suffix}_o2m": v for k, v in {**lb2, **lc2}.items()})

    losses["core_loss"] = core
    return losses
