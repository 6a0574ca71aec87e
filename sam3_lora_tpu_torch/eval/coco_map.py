"""Class-agnostic COCO mAP (segm/bbox), dependency-free numpy.

Re-implementation of the COCOeval protocol as used by the reference's
validation CLI (``validate_sam3_lora.py:1032-1051``: ``COCOeval(iouType=
'segm', useCats=False)`` → stats[0..2] = mAP, mAP@50, mAP@75, area=all,
maxDets=100). It needs no pycocotools: the
matching/accumulation logic (greedy per-image score-ordered matching, 101-point
interpolated AP over 10 IoU thresholds) is re-derived from the COCOeval
specification.

Inputs are in-memory per-image lists (no JSON round-trip):
  gts: {image_id: [{"mask": HxW bool, "iscrowd": 0/1}, ...]}
  dts: {image_id: [{"mask": HxW bool, "score": float}, ...]}
``mask`` may be replaced by ``box`` [x, y, w, h] for iouType="bbox".

The PyTorch port's copy of ``sam3_lora_tpu/eval/coco_map.py`` (it imports no
JAX); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _mask_iou_matrix(dts: List[np.ndarray], gts: List[np.ndarray], iscrowd) -> np.ndarray:
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    d = np.stack([m.reshape(-1).astype(np.float64) for m in dts])
    g = np.stack([m.reshape(-1).astype(np.float64) for m in gts])
    inter = d @ g.T
    da = d.sum(1)[:, None]
    ga = g.sum(1)[None, :]
    union = da + ga - inter
    # crowd GT: union = det area (COCO iscrowd semantics)
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da + 0 * ga, union)
    return inter / np.maximum(union, 1e-9)


def _box_iou_matrix(dts, gts, iscrowd) -> np.ndarray:
    if not len(dts) or not len(gts):
        return np.zeros((len(dts), len(gts)))
    d = np.asarray(dts, np.float64)  # xywh
    g = np.asarray(gts, np.float64)
    dx1, dy1, dx2, dy2 = d[:, 0], d[:, 1], d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1, gx2, gy2 = g[:, 0], g[:, 1], g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix = np.maximum(
        0, np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    )
    iy = np.maximum(
        0, np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    )
    inter = ix * iy
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da + 0 * ga, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


def _eval_image(dt_scores, iou, iscrowd, iou_thrs, max_dets=100):
    """Greedy COCO matching for one image.

    Returns (dt_matched (T, D) bool, dt_ignore (T, D) bool, n_gt).
    dts must already be score-sorted descending; iou is (D, G).
    """
    n_dt = min(len(dt_scores), max_dets)
    n_gt = iou.shape[1]
    n_crowd = int(np.sum(iscrowd))
    t = len(iou_thrs)
    dtm = np.zeros((t, n_dt), bool)
    dti = np.zeros((t, n_dt), bool)
    for ti, thr in enumerate(iou_thrs):
        gt_taken = np.zeros(n_gt, bool)
        for di in range(n_dt):
            best, best_iou = -1, min(thr, 1 - 1e-10)
            for gi in range(n_gt):
                if gt_taken[gi] and not iscrowd[gi]:
                    continue
                if best > -1 and not iscrowd[best] and iscrowd[gi]:
                    break  # crowd GTs sorted last; stop once matched to non-crowd
                if iou[di, gi] < best_iou:
                    continue
                best_iou = iou[di, gi]
                best = gi
            if best == -1:
                continue
            gt_taken[best] = True
            if iscrowd[best]:
                dti[ti, di] = True  # matches to crowd are ignored, not TP
            else:
                dtm[ti, di] = True
    return dtm, dti, n_gt - n_crowd


def accumulate_pooled(all_scores, all_dtm, all_dti, n_gt_total, t):
    """COCOeval ``accumulate``: pool per-image match matrices across all
    evaluation units, re-sort by score, and compute 101-point-interpolated
    AP + final recall per IoU threshold. Shared by the image mAP above and
    the video/tracklet AP evaluators (eval/saco_veval.py)."""
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    dtm = np.concatenate(all_dtm, axis=1) if all_dtm else np.zeros((t, 0), bool)
    dti = np.concatenate(all_dti, axis=1) if all_dti else np.zeros((t, 0), bool)
    order = np.argsort(-scores, kind="mergesort")
    dtm, dti = dtm[:, order], dti[:, order]

    ap = np.zeros(t)
    recall_at = np.zeros(t)
    for ti in range(t):
        keep = ~dti[ti]
        tps = np.cumsum(dtm[ti][keep]).astype(np.float64)
        fps = np.cumsum(~dtm[ti][keep]).astype(np.float64)
        rc = tps / n_gt_total
        pr = tps / np.maximum(tps + fps, 1e-9)
        recall_at[ti] = rc[-1] if len(rc) else 0.0
        # precision envelope (monotone non-increasing from the right)
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        # 101-point interpolation
        idx = np.searchsorted(rc, RECALL_THRS, side="left")
        q = np.zeros(len(RECALL_THRS))
        ok = idx < len(pr)
        q[ok] = pr[idx[ok]]
        ap[ti] = q.mean()
    return ap, recall_at


def evaluate_coco_map(
    gts: Dict,
    dts: Dict,
    iou_type: str = "segm",
    max_dets: int = 100,
    iou_thrs: Sequence[float] = IOU_THRS,
) -> Dict[str, float]:
    """Class-agnostic mAP. Returns {'mAP', 'mAP_50', 'mAP_75', 'AR_100'}."""
    iou_thrs = np.asarray(iou_thrs)
    t = len(iou_thrs)
    all_scores, all_dtm, all_dti = [], [], []
    n_gt_total = 0

    image_ids = sorted(set(gts.keys()) | set(dts.keys()))
    for img_id in image_ids:
        g = list(gts.get(img_id, []))
        d = list(dts.get(img_id, []))
        # crowd GTs last (COCOeval sorts by _ignore)
        g.sort(key=lambda x: x.get("iscrowd", 0))
        d.sort(key=lambda x: -x["score"])
        d = d[:max_dets]
        iscrowd = [int(x.get("iscrowd", 0)) for x in g]
        if iou_type == "segm":
            iou = _mask_iou_matrix(
                [x["mask"] for x in d], [x["mask"] for x in g], iscrowd
            )
        else:
            iou = _box_iou_matrix(
                [x["box"] for x in d], [x["box"] for x in g], iscrowd
            )
        scores = np.array([x["score"] for x in d])
        dtm, dti, n_gt = _eval_image(scores, iou, iscrowd, iou_thrs, max_dets)
        all_scores.append(scores)
        all_dtm.append(dtm)
        all_dti.append(dti)
        n_gt_total += n_gt

    if n_gt_total == 0:
        return {"mAP": -1.0, "mAP_50": -1.0, "mAP_75": -1.0, "AR_100": -1.0}

    ap, recall_at = accumulate_pooled(all_scores, all_dtm, all_dti, n_gt_total, t)

    return {
        "mAP": float(ap.mean()),
        "mAP_50": float(ap[0]),
        "mAP_75": float(ap[5]),
        "AR_100": float(recall_at.mean()),
    }
