"""cgF1 — SAM3's concept-grounding F1 (class-agnostic), dependency-free.

Re-derivation of the reference evaluator's semantics
(``sam3/eval/cgf1_eval.py:179-447``):

* per (image, query): keep detections with score >= 0.5; optimal one-to-one
  assignment (max-IoU LSAP) between kept dets and non-ignored GTs;
  per IoU threshold t in 0.5:0.05:0.95 — TP = #pairs with IoU >= t,
  FP = n_dt - TP, FN = n_gt - TP;
* image-level confusion: IL_TP iff (gt>0 and dt>0), IL_FP iff (gt==0, dt>0),
  IL_TN iff both 0, IL_FN iff (gt>0, dt==0);
* accumulate: positive-micro precision uses only FPs from images with both
  gt and dt present; IL_MCC = Matthews corr of the image-level confusion;
  cgF1 = positive_micro_F1 * IL_MCC, reported averaged over thresholds and
  at 0.5 / 0.75.

Same in-memory inputs as ``coco_map.evaluate_coco_map``.

The PyTorch port's copy of ``sam3_lora_tpu/eval/cgf1.py`` (it imports no
JAX); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.optimize import linear_sum_assignment

from .coco_map import IOU_THRS, _box_iou_matrix, _mask_iou_matrix


def cgf1_from_counts(TPs, pmFPs, FNs, il_tp, il_fp, il_tn, il_fn):
    """The reference accumulator's arithmetic (cgf1_eval.py accumulate):
    counts -> (cgF1 per-threshold, positive-micro F1/precision/recall arrays,
    IL_F1, IL_MCC). Shared with the video demo-F1 evaluator
    (eval/saco_veval.py::evaluate_video_cgf1)."""
    recall = TPs / (TPs + FNs + 1e-4)
    pm_precision = TPs / (TPs + pmFPs + 1e-4)
    pm_f1 = 2 * pm_precision * recall / (pm_precision + recall + 1e-4)

    il_rec = il_tp / (il_tp + il_fn + 1e-6)
    il_prec = il_tp / (il_tp + il_fp + 1e-6)
    il_f1 = 2 * il_prec * il_rec / (il_prec + il_rec + 1e-6)
    denom = (
        float(il_tp + il_fp) * float(il_tp + il_fn)
        * float(il_tn + il_fp) * float(il_tn + il_fn)
    ) ** 0.5 + 1e-6
    il_mcc = float(il_tp * il_tn - il_fp * il_fn) / denom

    cgf1 = pm_f1 * il_mcc
    return cgf1, pm_f1, pm_precision, recall, il_f1, il_mcc


def evaluate_cgf1(
    gts: Dict,
    dts: Dict,
    iou_type: str = "segm",
    score_threshold: float = 0.5,
) -> Dict[str, float]:
    iou_thrs = IOU_THRS
    t = len(iou_thrs)
    TPs = np.zeros(t, np.int64)
    FPs = np.zeros(t, np.int64)
    pmFPs = np.zeros(t, np.int64)
    FNs = np.zeros(t, np.int64)
    il_tp = il_fp = il_tn = il_fn = 0

    image_ids = sorted(set(gts.keys()) | set(dts.keys()))
    for img_id in image_ids:
        g = [x for x in gts.get(img_id, []) if not x.get("ignore", False)]
        d = [x for x in dts.get(img_id, []) if x["score"] >= score_threshold]
        n_gt, n_dt = len(g), len(d)
        il_tp += int(n_gt > 0 and n_dt > 0)
        il_fp += int(n_gt == 0 and n_dt > 0)
        il_tn += int(n_gt == 0 and n_dt == 0)
        il_fn += int(n_gt > 0 and n_dt == 0)
        if n_gt == 0 and n_dt == 0:
            continue
        if n_dt == 0:
            FNs += n_gt
            continue
        iscrowd = [0] * n_gt
        if iou_type == "segm":
            iou = _mask_iou_matrix([x["mask"] for x in d], [x["mask"] for x in g], iscrowd)
        else:
            iou = _box_iou_matrix([x["box"] for x in d], [x["box"] for x in g], iscrowd)
        di, gi = linear_sum_assignment(-iou)
        match_iou = iou[di, gi]
        positive_img = n_gt > 0 and n_dt > 0
        for ti, thr in enumerate(iou_thrs):
            tp = int((match_iou >= thr).sum())
            TPs[ti] += tp
            FPs[ti] += n_dt - tp
            FNs[ti] += n_gt - tp
            if positive_img:
                pmFPs[ti] += n_dt - tp

    cgf1, pm_f1, pm_precision, recall, il_f1, il_mcc = cgf1_from_counts(
        TPs, pmFPs, FNs, il_tp, il_fp, il_tn, il_fn
    )
    return {
        "cgF1": float(cgf1.mean()),
        "cgF1_50": float(cgf1[0]),
        "cgF1_75": float(cgf1[5]),
        "precision": float(pm_precision.mean()),
        "recall": float(recall.mean()),
        "IL_F1": float(il_f1),
        "IL_MCC": float(il_mcc),
    }
