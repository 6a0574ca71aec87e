"""TIDE-style detection error decomposition (class-agnostic).

The reference's offline evaluator runs TIDE over dumped prediction files
(``sam3/eval/coco_eval_offline.py`` "incl. TIDE"). This is the
class-agnostic slice of the TIDE taxonomy (Bolya et al., ECCV 2020) that
applies to SAM3's single-concept queries — classification/confusion errors
don't exist without classes, leaving:

* **Loc**  — localization: best IoU in [bg_thresh, fg_thresh) with an
  unmatched GT (right object, wrong extent)
* **Dup**  — duplicate: IoU >= fg_thresh but the GT was already claimed by
  a higher-scoring detection
* **Bkg**  — background: best IoU < bg_thresh against every GT
* **Miss** — GT never matched by any detection

plus the oracle impact of each class: the mAP obtained after deleting that
error type's detections (or restoring missed GTs), the number TIDE reports
as dAP.

The PyTorch port's copy of ``sam3_lora_tpu/eval/tide.py`` (it imports no
JAX); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .coco_map import _box_iou_matrix, _mask_iou_matrix, evaluate_coco_map

__all__ = ["tide_errors"]


def _iou_matrix(dts: List[dict], gts: List[dict], iou_type: str) -> np.ndarray:
    if iou_type == "segm":
        return _mask_iou_matrix(
            [d["mask"] for d in dts], [g["mask"] for g in gts],
            [g.get("iscrowd", 0) for g in gts],
        )
    return _box_iou_matrix(
        [d["box"] for d in dts], [g["box"] for g in gts],
        [g.get("iscrowd", 0) for g in gts],
    )


def tide_errors(
    gts: Dict[int, List[dict]],
    dts: Dict[int, List[dict]],
    iou_type: str = "segm",
    fg_thresh: float = 0.5,
    bg_thresh: float = 0.1,
) -> Dict[str, float]:
    """Classify every detection/GT into the TIDE error classes and measure
    each class's oracle mAP impact (dAP_*). Inputs are the evaluator's
    in-memory dicts ({image_id: [{"mask"|"box", "score", ...}]})."""
    base = evaluate_coco_map(gts, dts, iou_type=iou_type)["mAP"]

    counts = {"Loc": 0, "Dup": 0, "Bkg": 0, "Miss": 0, "TP": 0}
    labels: Dict[int, List[str]] = {}
    matched_gt: Dict[int, np.ndarray] = {}

    image_ids = sorted(set(gts) | set(dts))
    for iid in image_ids:
        g = gts.get(iid, [])
        d = sorted(dts.get(iid, []), key=lambda x: -x["score"])
        lab = []
        taken = np.zeros(len(g), bool)
        iou = _iou_matrix(d, g, iou_type) if (d and g) else np.zeros((len(d), len(g)))
        for di in range(len(d)):
            row = iou[di] if len(g) else np.zeros(0)
            free = row.copy()
            if len(g):
                free[taken] = -1.0
            best_free = float(free.max()) if len(g) else 0.0
            best_any = float(row.max()) if len(g) else 0.0
            if len(g) and best_free >= fg_thresh:
                taken[int(np.argmax(free))] = True
                lab.append("TP")
            elif best_any >= fg_thresh:
                lab.append("Dup")
            elif best_any >= bg_thresh:
                lab.append("Loc")
            else:
                lab.append("Bkg")
            counts[lab[-1]] += 1
        counts["Miss"] += int((~taken).sum())
        labels[iid] = lab
        matched_gt[iid] = taken

    out: Dict[str, float] = {
        "mAP": base,
        **{f"n_{k}": float(v) for k, v in counts.items()},
    }

    # oracle impact: remove one error class at a time
    def drop(err: str) -> float:
        fixed = {
            iid: [d for d, l in zip(
                sorted(dts.get(iid, []), key=lambda x: -x["score"]),
                labels[iid],
            ) if l != err]
            for iid in image_ids
        }
        return evaluate_coco_map(gts, fixed, iou_type=iou_type)["mAP"]

    for err in ("Loc", "Dup", "Bkg"):
        out[f"dAP_{err}"] = (drop(err) - base) if counts[err] else 0.0

    # Miss: oracle restores unmatched GTs as perfect max-score detections
    if counts["Miss"]:
        fixed = {
            iid: list(dts.get(iid, []))
            + [
                dict(g, score=1.0)
                for g, t in zip(gts.get(iid, []), matched_gt.get(iid, []))
                if not t
            ]
            for iid in image_ids
        }
        out["dAP_Miss"] = evaluate_coco_map(gts, fixed, iou_type=iou_type)["mAP"] - base
    else:
        out["dAP_Miss"] = 0.0
    return out
