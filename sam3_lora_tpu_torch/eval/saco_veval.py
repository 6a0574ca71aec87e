"""SA-Co video-eval ("veval") plumbing: YT-VIS-format file-level evaluators.

The port's own copy of ``sam3_lora_tpu/eval/saco_veval.py`` (which imports
no JAX): the equivalent of the reference's saco_veval stack —
``sam3/eval/saco_veval_evaluators.py`` (838 LoC) plus the tracklet-IoU
mixin / results writer in ``sam3/eval/ytvis_eval.py`` — the one §2.5
surface the metric layer (video_eval.py) did not yet cover.  Given a
YT-VIS-format GT dict (``videos``/``annotations``/``categories`` [+
``video_np_pairs``]) and a prediction list (records with ``video_id``,
``category_id``, ``score``, per-frame ``bboxes``/``segmentations``/
``areas``), computes:

* video mAP (class-based)          — YTVISPredFileEvaluator  :51-113
* phrase AP (class-agnostic)       — VideoPhraseApEvaluator  :116-181
* video cgF1 / IL_MCC (demo F1)    — VideoCGF1Evaluator      :184-325
* phrase HOTA                      — VideoPhraseHotaEvaluator:493-677,
  pooled across pseudo-videos with trackeval's COMBINED_SEQ semantics
  (hota_eval_toolkit/trackeval/metrics/hota.py:175-191)
* TETA                             — VideoTetaEvaluator      :328-490,
  combined per teta_eval_toolkit/metrics/teta.py:260-288.  (The vendored
  TETA toolkit ships without its ``datasets`` module, so the reference's
  own TETA plumbing cannot even import as shipped; we evaluate each
  (video, category) pair as a single-class sequence — the metric itself
  is oracle-checked in video_eval.py.)

The metric math lives in video_eval.py / coco_map.py / cgf1.py, each
cross-checked against the reference's own evaluators
(tests/test_eval_crosscheck.py); this module is the format / remapping /
thresholding plumbing, itself cross-checked file-level against the
reference's VideoPhraseApEvaluator / YTVISPredFileEvaluator /
VideoCGF1Evaluator running over the pycocotools shim
(tests/test_saco_veval.py).

Spatio-temporal tracklet IoU follows YTVISevalMixin.computeIoU
(ytvis_eval.py:67-147): masklets sum per-frame intersection/union areas
with ``None`` = absent (both-empty tracklet pairs score IoU 1); box
tracklets sum per-frame xywh intersections/unions with ``None`` = zero
box (ytvis_coco_wrapper.py:40-53, :99-112).
"""

from __future__ import annotations

import copy
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.rle import rle_decode, rle_encode
from .cgf1 import cgf1_from_counts
from .coco_map import IOU_THRS, _eval_image, accumulate_pooled
from .video_eval import evaluate_hota, evaluate_teta

__all__ = [
    "remap_video_category_pairs",
    "evaluate_video_map",
    "evaluate_phrase_ap",
    "evaluate_video_cgf1",
    "evaluate_phrase_hota",
    "evaluate_video_teta",
    "evaluate_saco_veval",
    "combine_hota_sequences",
    "combine_teta_sequences",
    "prepare_video_predictions",
    "dedup_video_predictions",
    "SacoVevalWriter",
]


# ---------------------------------------------------------------------------
# decoding / tracklet IoU
# ---------------------------------------------------------------------------


def _decode_any(rle: Dict) -> np.ndarray:
    """COCO RLE (compressed string/bytes or uncompressed integer-list
    counts) -> (H, W) bool mask."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):
        h, w = rle["size"]
        runs = np.asarray(counts, dtype=np.int64)
        vals = np.zeros(len(runs), dtype=np.uint8)
        vals[1::2] = 1
        flat = np.repeat(vals, runs)
        if flat.size < h * w:
            flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
        return flat[: h * w].reshape((w, h)).T.astype(bool)
    return rle_decode(rle).astype(bool)


def _tracklet_iou_masks(d_frames: List, g_frames: List) -> float:
    """ytvis_eval.py:117-141 ``iou_masklets`` over decoded per-frame masks
    (None = absent). Both-empty pairs score 1."""
    inter = 0.0
    union = 0.0
    for dm, gm in zip(d_frames, g_frames):
        if dm is not None and gm is not None:
            inter += float(np.logical_and(dm, gm).sum())
            union += float(np.logical_or(dm, gm).sum())
        elif gm is not None:
            union += float(gm.sum())
        elif dm is not None:
            union += float(dm.sum())
    return inter / union if union > 0 else 1.0


def _tracklet_iou_boxes(d_frames: List, g_frames: List) -> float:
    """ytvis_eval.py:102-115 ``iou_tracklets``: per-frame xywh
    intersection/union summed over time (None = zero box)."""
    inter = 0.0
    union = 0.0
    for db, gb in zip(d_frames, g_frames):
        d = db if db is not None else (0.0, 0.0, 0.0, 0.0)
        g = gb if gb is not None else (0.0, 0.0, 0.0, 0.0)
        ix = max(0.0, min(d[0] + d[2], g[0] + g[2]) - max(d[0], g[0]))
        iy = max(0.0, min(d[1] + d[3], g[1] + g[3]) - max(d[1], g[1]))
        i = ix * iy
        inter += i
        union += d[2] * d[3] + g[2] * g[3] - i
    return inter / union if union > 0 else 0.0


def _iou_matrix(d_items: List[Dict], g_items: List[Dict], iou_type: str) -> np.ndarray:
    fn = _tracklet_iou_masks if iou_type == "segm" else _tracklet_iou_boxes
    out = np.zeros((len(d_items), len(g_items)))
    for i, d in enumerate(d_items):
        for j, g in enumerate(g_items):
            out[i, j] = fn(d["frames"], g["frames"])
    return out


def _ann_frames(ann: Dict, iou_type: str, num_frames: int) -> List:
    """One annotation/prediction record -> per-frame mask-or-box list."""
    if iou_type == "segm":
        segs = ann.get("segmentations") or [None] * num_frames
        return [None if s is None else _decode_any(s) for s in segs]
    boxes = ann.get("bboxes")
    if boxes is None:
        raise ValueError("bbox evaluation needs 'bboxes' in every record")
    return list(boxes)


def _video_num_frames(gt: Dict) -> Dict[int, int]:
    out = {}
    for v in gt["videos"]:
        n = v.get("length") or len(v.get("file_names", [])) or 0
        out[int(v["id"])] = int(n)
    return out


# ---------------------------------------------------------------------------
# (video_id, category_id) -> pseudo-video remapping
# ---------------------------------------------------------------------------


def remap_video_category_pairs(
    gt: Dict, dt: List[Dict], add_negative_np_pairs: bool = False
) -> Tuple[Dict, List[Dict]]:
    """Remap each (video_id, category_id) pair to a fresh unique video id so
    class-agnostic matching never mixes phrases from the same video —
    saco_veval_evaluators.py:707-770 semantics exactly: pairs collected from
    BOTH dt and gt annotations, sorted, numbered from 1; negative NP pairs
    (gt["video_np_pairs"]) appended after when requested (IL_MCC/cgF1 need
    the true negatives); every remapped video entry keeps orig_video_id /
    orig_category_id. Inputs are not mutated (the reference mutates freshly
    loaded JSON; we receive live objects)."""
    gt = copy.deepcopy(gt)
    dt = copy.deepcopy(dt)
    video_by_id = {int(v["id"]): v for v in gt["videos"]}
    pairs = set()
    for p in dt:
        pairs.add((int(p["video_id"]), int(p["category_id"])))
    for a in gt["annotations"]:
        pairs.add((int(a["video_id"]), int(a["category_id"])))
    new_id = {pair: i + 1 for i, pair in enumerate(sorted(pairs))}
    if add_negative_np_pairs:
        for vnp in gt.get("video_np_pairs", []):
            pair = (int(vnp["video_id"]), int(vnp["category_id"]))
            if pair not in new_id:
                new_id[pair] = len(new_id) + 1
    for p in dt:
        p["video_id"] = new_id[(int(p["video_id"]), int(p["category_id"]))]
    for a in gt["annotations"]:
        a["video_id"] = new_id[(int(a["video_id"]), int(a["category_id"]))]
    new_videos = []
    for (vid, cid), nid in new_id.items():
        v = dict(video_by_id[vid])
        v["id"] = nid
        v["orig_video_id"] = vid
        v["orig_category_id"] = cid
        new_videos.append(v)
    gt["videos"] = new_videos
    return gt, dt


def _collect_units(
    gt: Dict,
    dt: List[Dict],
    iou_type: str,
    use_cats: bool,
) -> Dict[Tuple[int, int], Tuple[List[Dict], List[Dict]]]:
    """Group gt/dt into evaluation units. With use_cats each (video_id,
    category_id) pair matches independently (COCOeval useCats=True); without,
    the unit is the whole video (callers remap first, VideoPhraseApEvaluator
    :137). Every gt video appears even when empty on both sides."""
    nframes = _video_num_frames(gt)
    units: Dict[Tuple[int, int], Tuple[List, List]] = {}

    def key(vid, cid):
        return (int(vid), int(cid) if use_cats else -1)

    if not use_cats:
        # every gt video is an evaluation unit even when empty on both sides
        # (COCOeval imgIds = all gt images; negatives matter for IL metrics)
        for v in gt["videos"]:
            units.setdefault((int(v["id"]), -1), ([], []))
    for a in gt["annotations"]:
        k = key(a["video_id"], a.get("category_id", -1))
        units.setdefault(k, ([], []))
        n = nframes.get(int(a["video_id"]), 0) or len(
            a.get("segmentations") or a.get("bboxes") or []
        )
        units[k][0].append(
            {
                "frames": _ann_frames(a, iou_type, n),
                "iscrowd": int(a.get("iscrowd", 0)),
                "ignore": bool(a.get("ignore", 0)) or bool(a.get("iscrowd", 0)),
            }
        )
    for p in dt:
        k = key(p["video_id"], p.get("category_id", -1))
        units.setdefault(k, ([], []))
        n = nframes.get(int(p["video_id"]), 0) or len(
            p.get("segmentations") or p.get("bboxes") or []
        )
        units[k][1].append(
            {
                "frames": _ann_frames(p, iou_type, n),
                "score": float(p["score"]),
            }
        )
    # with use_cats, gt videos with no anns/dts for a category contribute no
    # unit (COCOeval only visits (img, cat) pairs via catIds x imgIds; empty
    # ones produce empty evalImgs) — units from anns/preds alone suffice.
    if use_cats:
        units = {k: v for k, v in units.items() if v[0] or v[1]}
    return units


# ---------------------------------------------------------------------------
# AP evaluators (class-based video mAP + class-agnostic phrase AP)
# ---------------------------------------------------------------------------


def _pooled_track_ap(
    units: Dict, iou_type: str, iou_thrs: np.ndarray, max_dets: int = 100
) -> Dict[str, np.ndarray]:
    """COCOeval evaluate+accumulate over tracklet units (greedy per-unit
    score-ordered matching, pooled 101-point AP — coco_map machinery)."""
    t = len(iou_thrs)
    all_scores, all_dtm, all_dti = [], [], []
    n_gt_total = 0
    for (_vid, _cid), (g, d) in sorted(units.items()):
        g = sorted(g, key=lambda x: x["ignore"])
        d = sorted(d, key=lambda x: -x["score"])[:max_dets]
        iscrowd = [x["iscrowd"] for x in g]
        iou = _iou_matrix(d, g, iou_type)
        scores = np.array([x["score"] for x in d])
        dtm, dti, n_gt = _eval_image(scores, iou, iscrowd, iou_thrs, max_dets)
        all_scores.append(scores)
        all_dtm.append(dtm)
        all_dti.append(dti)
        n_gt_total += n_gt
    if n_gt_total == 0:
        return {"ap": np.full(t, -1.0), "ar": np.full(t, -1.0)}
    ap, ar = accumulate_pooled(all_scores, all_dtm, all_dti, n_gt_total, t)
    return {"ap": ap, "ar": ar}


def evaluate_video_map(
    gt: Dict,
    dt: List[Dict],
    iou_types: Sequence[str] = ("bbox", "segm"),
    dataset_name: str = "video",
) -> Tuple[Dict[str, float], Dict]:
    """Class-based YT-VIS track mAP (YTVISPredFileEvaluator :65-113):
    categories kept, stats[0] = AP@[.5:.95] area=all maxDets=100. COCOeval's
    useCats accumulation pools videos WITHIN each category then averages AP
    over categories that have ground truth (empty-GT categories are -1 and
    excluded from the mean)."""
    results = {}
    for iou_type in iou_types:
        units = _collect_units(gt, dt, iou_type, use_cats=True)
        by_cat: Dict[int, Dict] = defaultdict(dict)
        for (vid, cid), v in units.items():
            by_cat[cid][(vid, cid)] = v
        aps = []
        for cid in sorted(by_cat):
            r = _pooled_track_ap(by_cat[cid], iou_type, IOU_THRS)
            if r["ap"][0] != -1.0:  # category has ground truth
                aps.append(r["ap"])
        key = f"{dataset_name}_{'mask' if iou_type == 'segm' else 'bbox'}_mAP_50_95"
        results[key] = float(np.mean(aps)) if aps else -1.0
    return results, {}


def evaluate_phrase_ap(
    gt: Dict,
    dt: List[Dict],
    iou_types: Sequence[str] = ("bbox", "segm"),
    dataset_name: str = "video",
) -> Tuple[Dict[str, float], Dict]:
    """Class-agnostic phrase AP (VideoPhraseApEvaluator :130-181): remap
    (video, category) pairs to pseudo-videos, then useCats=False AP."""
    gt_r, dt_r = remap_video_category_pairs(gt, dt)
    results = {}
    for iou_type in iou_types:
        units = _collect_units(gt_r, dt_r, iou_type, use_cats=False)
        r = _pooled_track_ap(units, iou_type, IOU_THRS)
        pre = f"{dataset_name}_{'mask' if iou_type == 'segm' else 'bbox'}_phrase_ap"
        results[pre + "_50_95"] = float(r["ap"].mean())
        results[pre + "_50"] = float(r["ap"][0])
        results[pre + "_75"] = float(r["ap"][5])
    return results, {}


# ---------------------------------------------------------------------------
# video cgF1 (demo F1) — VideoCGF1Evaluator
# ---------------------------------------------------------------------------


def evaluate_video_cgf1(
    gt: Dict,
    dt: List[Dict],
    prob_thresh: float = 0.5,
    iou_types: Sequence[str] = ("bbox", "segm"),
    dataset_name: str = "video",
) -> Tuple[Dict[str, float], Dict]:
    """Video demo-F1 / cgF1 / IL_MCC (VideoCGF1Evaluator :200-325): per
    pseudo-video, keep dets with score >= prob_thresh (cgf1_eval.py:252),
    optimal LSAP matching on tracklet IoU, CGF1Eval accumulation
    (cgf1.cgf1_from_counts). IL metrics and dataset-level cgF1 need the
    negative video-NP pairs (gt["video_np_pairs"]); without them only the
    per-video-NP TP/FP/FN/F1 table is produced, like the reference."""
    from scipy.optimize import linear_sum_assignment

    compute_ilmcc = "video_np_pairs" in gt
    gt_r, dt_r = remap_video_category_pairs(
        gt, dt, add_negative_np_pairs=compute_ilmcc
    )
    iou_thrs = IOU_THRS
    t = len(iou_thrs)
    i50 = int(np.argmin(np.abs(iou_thrs - 0.5)))
    i75 = int(np.argmin(np.abs(iou_thrs - 0.75)))
    results: Dict[str, float] = {}
    video_np_level: Dict[Tuple[int, int], Dict[str, float]] = {}

    orig_pair = {
        int(v["id"]): (int(v["orig_video_id"]), int(v["orig_category_id"]))
        for v in gt_r["videos"]
    }

    for iou_type in iou_types:
        units = _collect_units(gt_r, dt_r, iou_type, use_cats=False)
        TPs = np.zeros(t, np.int64)
        pmFPs = np.zeros(t, np.int64)
        FNs = np.zeros(t, np.int64)
        il_tp = il_fp = il_tn = il_fn = 0
        prefix = "mask" if iou_type == "segm" else "bbox"

        for (vid, _), (g_all, d_all) in sorted(units.items()):
            g = [x for x in g_all if not x["ignore"]]
            d = [x for x in d_all if x["score"] >= prob_thresh]
            n_gt, n_dt = len(g), len(d)
            il_tp += int(n_gt > 0 and n_dt > 0)
            il_fp += int(n_gt == 0 and n_dt > 0)
            il_tn += int(n_gt == 0 and n_dt == 0)
            il_fn += int(n_gt > 0 and n_dt == 0)
            if n_dt > 0 and n_gt > 0:
                iou = _iou_matrix(d, g, iou_type)
                di, gi = linear_sum_assignment(-iou)
                match_iou = iou[di, gi]
                tp = (match_iou[None, :] >= iou_thrs[:, None]).sum(1)
            else:
                tp = np.zeros(t, np.int64)
            fp = n_dt - tp
            fn = n_gt - tp
            TPs += tp
            FNs += fn
            if n_gt > 0 and n_dt > 0:
                pmFPs += fp
            # per-video-NP table (saco_veval_evaluators.py:287-325)
            denom = 2 * tp + fp + fn
            f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 1.0)
            pair = orig_pair[vid]
            video_np_level.setdefault(pair, {}).update(
                {
                    f"{prefix}_TP_50_95": float(tp.mean()),
                    f"{prefix}_FP_50_95": float(fp.mean()),
                    f"{prefix}_FN_50_95": float(fn.mean()),
                    f"{prefix}_F1_50_95": float(f1.mean()),
                    f"{prefix}_TP_50": float(tp[i50]),
                    f"{prefix}_FP_50": float(fp[i50]),
                    f"{prefix}_FN_50": float(fn[i50]),
                    f"{prefix}_F1_50": float(f1[i50]),
                    f"{prefix}_TP_75": float(tp[i75]),
                    f"{prefix}_FP_75": float(fp[i75]),
                    f"{prefix}_FN_75": float(fn[i75]),
                    f"{prefix}_F1_75": float(f1[i75]),
                }
            )

        if compute_ilmcc:
            cgf1, pm_f1, _, _, _, il_mcc = cgf1_from_counts(
                TPs, pmFPs, FNs, il_tp, il_fp, il_tn, il_fn
            )
            pre = f"{dataset_name}_{prefix}_demo"
            results[pre + "_cgf1_micro_50_95"] = float(cgf1.mean())
            results[pre + "_ilmcc_50_95"] = float(il_mcc)
            results[pre + "_positive_micro_f1_50_95"] = float(pm_f1.mean())
            with np.errstate(invalid="ignore", divide="ignore"):
                # 0/0 -> nan when pm_f1 is 0 at a threshold, same as the
                # reference's ratio (saco_veval_evaluators.py:263-266)
                results[pre + "_cgf1_micro_50"] = float(cgf1[i50])
                results[pre + "_ilmcc_50"] = float(cgf1[i50] / pm_f1[i50])
                results[pre + "_positive_micro_f1_50"] = float(pm_f1[i50])
                results[pre + "_cgf1_micro_75"] = float(cgf1[i75])
                results[pre + "_ilmcc_75"] = float(cgf1[i75] / pm_f1[i75])
                results[pre + "_positive_micro_f1_75"] = float(pm_f1[i75])

    return results, video_np_level


# ---------------------------------------------------------------------------
# phrase HOTA — VideoPhraseHotaEvaluator
# ---------------------------------------------------------------------------

_HOTA_METRICS = (
    "HOTA", "DetA", "AssA", "DetRe", "DetPr", "AssRe", "AssPr", "LocA", "OWTA",
)


def combine_hota_sequences(seq_results: List[Dict]) -> Dict[str, float]:
    """trackeval COMBINED_SEQ pooling (hota.py:175-191): sum TP/FN/FP per
    alpha, HOTA_TP-weighted average of AssA/AssRe/AssPr/LocA, recompute the
    final fields; scalars are means over the 19 alphas."""
    if not seq_results:
        return {m: 0.0 for m in _HOTA_METRICS}
    tp = sum(r["HOTA_TP_array"] for r in seq_results)
    fn = sum(r["HOTA_FN_array"] for r in seq_results)
    fp = sum(r["HOTA_FP_array"] for r in seq_results)
    res = {"HOTA_TP": tp, "HOTA_FN": fn, "HOTA_FP": fp}
    for f in ("AssRe", "AssPr", "AssA"):
        res[f] = sum(r[f + "_array"] * r["HOTA_TP_array"] for r in seq_results)
        res[f] = res[f] / np.maximum(1.0, tp)
    loca_num = sum(r["LocA_array"] * r["HOTA_TP_array"] for r in seq_results)
    res["LocA"] = np.maximum(1e-10, loca_num) / np.maximum(1e-10, tp)
    res["DetRe"] = tp / np.maximum(1, tp + fn)
    res["DetPr"] = tp / np.maximum(1, tp + fp)
    res["DetA"] = tp / np.maximum(1, tp + fn + fp)
    res["HOTA"] = np.sqrt(res["DetA"] * res["AssA"])
    res["OWTA"] = np.sqrt(res["DetRe"] * res["AssA"])
    out = {m: float(np.mean(res[m])) for m in _HOTA_METRICS}
    out.update({m + "_array": res[m] for m in _HOTA_METRICS})
    return out


def _records_to_tracks(items: List[Dict], iou_type: str) -> Dict:
    """Per-frame lists -> the in-memory track dicts video_eval expects
    ({tid: {frame: (H,W) bool mask | xyxy box}}, None frames absent)."""
    tracks = {}
    for tid, it in enumerate(items):
        tr = {}
        for f, v in enumerate(it["frames"]):
            if v is None:
                continue
            if iou_type == "segm":
                tr[f] = v
            else:
                x, y, w, h = v
                tr[f] = np.array([x, y, x + w, y + h], np.float64)
        tracks[tid] = tr
    return tracks


def _drop_empty_frames(p: Dict) -> None:
    """HOTA pre-pass (saco_veval_evaluators.py:538-545): a frame with zero
    area / missing / all-zero box must not count as a detection."""
    boxes = p.get("bboxes")
    areas = p.get("areas")
    segs = p.get("segmentations")
    n = len(boxes) if boxes is not None else len(segs or [])
    for i in range(n):
        a = areas[i] if areas is not None else None
        if boxes is not None:
            b = boxes[i]
            empty = (a is not None and a == 0) or b is None or all(
                x == 0 for x in b
            )
        else:
            # mask-only record (no bboxes key): decide emptiness from the
            # area / segmentation instead of treating every frame as empty
            s = segs[i] if segs is not None else None
            empty = s is None or (a is not None and a == 0)
        if empty:
            if segs is not None:
                segs[i] = None
            if boxes is not None:
                boxes[i] = None
            if areas is not None:
                areas[i] = None


def evaluate_phrase_hota(
    gt: Dict,
    dt: List[Dict],
    prob_thresh: float = 0.5,
    iou_types: Sequence[str] = ("bbox", "segm"),
    dataset_name: str = "video",
) -> Tuple[Dict[str, float], Dict]:
    """Phrase HOTA (VideoPhraseHotaEvaluator :526-629): keep dets with score
    STRICTLY above prob_thresh (:534), null out empty frames (:538-545),
    remap (video, category) -> pseudo-videos, run HOTA per pseudo-video and
    pool with trackeval COMBINED_SEQ; per-video-NP means over alphas."""
    dt = [copy.deepcopy(d) for d in dt if d["score"] > prob_thresh]
    for d in dt:
        _drop_empty_frames(d)
    gt_r, dt_r = remap_video_category_pairs(gt, dt)
    orig_pair = {
        int(v["id"]): (int(v["orig_video_id"]), int(v["orig_category_id"]))
        for v in gt_r["videos"]
    }
    results: Dict[str, float] = {}
    video_np_level: Dict[Tuple[int, int], Dict[str, float]] = {}
    for iou_type in iou_types:
        units = _collect_units(gt_r, dt_r, iou_type, use_cats=False)
        prefix = "mask" if iou_type == "segm" else "bbox"
        per_seq = []
        for (vid, _), (g, d) in sorted(units.items()):
            r = evaluate_hota(
                _records_to_tracks(g, iou_type), _records_to_tracks(d, iou_type)
            )
            per_seq.append(r)
            video_np_level.setdefault(orig_pair[vid], {}).update(
                {f"{prefix}_{m}": float(r[m]) for m in _HOTA_METRICS}
            )
        comb = combine_hota_sequences(per_seq)
        pre = f"{dataset_name}_{prefix}_all_phrase"
        for m in _HOTA_METRICS:
            results[f"{pre}_{m}"] = comb[m]
    return results, video_np_level


# ---------------------------------------------------------------------------
# TETA — VideoTetaEvaluator
# ---------------------------------------------------------------------------

_TETA_KEYS = (
    ("teta", "TETA"), ("loc_a", "LocA"), ("assoc_a", "AssocA"),
    ("cls_a", "ClsA"), ("loc_re", "LocRe"), ("loc_pr", "LocPr"),
    ("assoc_re", "AssocRe"), ("assoc_pr", "AssocPr"),
    ("cls_re", "ClsRe"), ("cls_pr", "ClsPr"),
)


def combine_teta_sequences(seq_results: List[Dict]) -> Dict[str, float]:
    """teta.py:260-288 combine: sum Loc/Cls count arrays, Loc_TP-weighted
    Assoc averages, recompute final fields. Scalars are means over the
    alpha labels, scaled x100 like the toolkit's summary rows
    (_base_metric.py:88-96) to match the reference's reported magnitudes."""
    from .video_eval import _teta_finalize

    if not seq_results:
        return {f"{k}": 0.0 for k, _ in _TETA_KEYS}
    res = {}
    for f in ("Loc_TP", "Loc_FN", "Loc_FP", "Cls_TP", "Cls_FN", "Cls_FP"):
        res[f] = sum(r[f + "_array"] for r in seq_results)
    for f in ("AssocRe", "AssocPr", "AssocA"):
        num = sum(r[f + "_array"] * r["Loc_TP_array"] for r in seq_results)
        res[f] = num / np.maximum(1.0, res["Loc_TP"])
    res = _teta_finalize(res)
    return {name: 100.0 * float(np.mean(res[field])) for name, field in _TETA_KEYS}


def evaluate_video_teta(
    gt: Dict,
    dt: List[Dict],
    prob_thresh: float = 0.5,
    use_mask: bool = False,
    dataset_name: str = "video",
) -> Tuple[Dict[str, float], Dict]:
    """TETA over (video, category) single-class sequences: score filter >=
    prob_thresh (VideoTetaEvaluator :376-377), each pair evaluated with the
    oracle-checked metric (video_eval.evaluate_teta) and pooled with the
    toolkit's combine_sequences. Key naming follows :455-486."""
    iou_type = "segm" if use_mask else "bbox"
    dt = [d for d in dt if d["score"] >= prob_thresh]
    units = _collect_units(gt, dt, iou_type, use_cats=True)
    per_seq = [
        evaluate_teta(
            _records_to_tracks(g, iou_type), _records_to_tracks(d, iou_type)
        )
        for (_vid, _cid), (g, d) in sorted(units.items())
    ]
    comb = combine_teta_sequences(per_seq)
    prefix = f"{dataset_name}_{'mask' if use_mask else 'bbox'}"
    return {f"{prefix}_{k}": v for k, v in comb.items()}, {}


# ---------------------------------------------------------------------------
# orchestrator + writer
# ---------------------------------------------------------------------------

_EVALUATORS: Dict[str, Callable] = {
    "video_map": evaluate_video_map,
    "phrase_ap": evaluate_phrase_ap,
    "video_cgf1": evaluate_video_cgf1,
    "phrase_hota": evaluate_phrase_hota,
    "teta": evaluate_video_teta,
}


def evaluate_saco_veval(
    gt,
    dt,
    evaluators: Sequence[str] = ("phrase_ap", "video_cgf1", "phrase_hota"),
    dataset_name: str = "video",
    **kwargs,
) -> Tuple[Dict[str, float], List[Dict]]:
    """Run the selected evaluators over a GT dict/path + prediction
    list/path, merging dataset-level meters and per-video-NP rows exactly
    like YTVISResultsWriter.compute_synced (ytvis_eval.py:366-405). Returns
    (meters, video_np_level_metrics) with the latter JSON-ready (video_id /
    category_id columns instead of tuple keys)."""
    if isinstance(gt, str):
        with open(gt) as f:
            gt = json.load(f)
    if isinstance(dt, str):
        with open(dt) as f:
            dt = json.load(f)
    meters: Dict[str, float] = {}
    np_level: Dict[Tuple[int, int], Dict[str, float]] = defaultdict(dict)
    for name in evaluators:
        fn = _EVALUATORS[name]
        res, per_np = fn(gt, dt, dataset_name=dataset_name, **kwargs.get(name, {}))
        meters.update(res)
        for pair, row in per_np.items():
            np_level[pair].update(row)
    rows = [
        {"video_id": vid, "category_id": cid, **row}
        for (vid, cid), row in sorted(np_level.items())
    ]
    return meters, rows


def prepare_video_predictions(
    video_id: int,
    scores: np.ndarray,
    labels: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
) -> List[Dict]:
    """Model outputs for one video -> YT-VIS prediction records
    (YTVISResultsWriter.prepare, ytvis_eval.py:201-270): boxes (N, T, 4)
    xyxy -> per-frame xywh lists; masks (N, T, H, W) bool -> per-frame RLEs
    + areas."""
    n = len(scores)
    records = []
    for i in range(n):
        rec: Dict = {
            "video_id": int(video_id),
            "category_id": int(labels[i]),
            "score": float(scores[i]),
        }
        if boxes is not None:
            b = np.asarray(boxes[i], np.float64)
            rec["bboxes"] = [
                [float(x1), float(y1), float(x2 - x1), float(y2 - y1)]
                for x1, y1, x2, y2 in b
            ]
        if masks is not None:
            m = np.asarray(masks[i]).astype(bool)
            rles, areas = [], []
            for t in range(m.shape[0]):
                area = int(m[t].sum())
                areas.append(area)
                rles.append(rle_encode(m[t].astype(np.uint8)) if area else None)
            rec["segmentations"] = rles
            rec["areas"] = areas
            if boxes is None:
                rec["bboxes"] = [
                    _mask_xywh(m[t]) if areas[t] else None for t in range(m.shape[0])
                ]
        records.append(rec)
    return records


def _mask_xywh(m: np.ndarray) -> List[float]:
    ys, xs = np.nonzero(m)
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    return [x0, y0, x1 - x0 + 1, y1 - y0 + 1]


def dedup_video_predictions(record_lists: List[List[Dict]]) -> List[Dict]:
    """Merge per-host prediction lists keeping ONE host's records per
    (video_id, category_id) — the reference's wrap-around-duplicate dedup
    (ytvis_eval.py:303-364): DataLoader padding makes the same sample appear
    on several ranks; duplicates would count as false positives."""
    merged: Dict[Tuple[int, int], List[Dict]] = {}
    for records in record_lists:
        by_key: Dict[Tuple[int, int], List[Dict]] = defaultdict(list)
        for r in records:
            by_key[(int(r["video_id"]), int(r["category_id"]))].append(r)
        for k, v in by_key.items():
            merged.setdefault(k, v)
    return [r for v in merged.values() for r in v]


class SacoVevalWriter:
    """Streaming YT-VIS prediction writer + evaluation runner — the
    reference's YTVISResultsWriter (ytvis_eval.py:160-411) re-shaped for the
    one-process-per-host runtime: each host appends records, writes a
    per-host shard (the filesystem-gather analogue, distributed.py:57-113);
    the primary merges shards with (video, category) dedup, dumps the final
    YT-VIS JSON, runs the evaluators, and writes the eval-metrics JSON
    beside it (ytvis_eval.py:385-398)."""

    def __init__(
        self,
        dump_file: str,
        evaluators: Sequence[str] = ("phrase_ap", "video_cgf1", "phrase_hota"),
        dataset_name: str = "video",
        eval_metrics_suffix: str = ".sam3_eval_metrics",
    ):
        self.dump_file = dump_file
        self.evaluators = tuple(evaluators)
        self.dataset_name = dataset_name
        self.eval_metrics_file = dump_file + eval_metrics_suffix
        self.records: List[Dict] = []
        os.makedirs(os.path.dirname(os.path.abspath(dump_file)), exist_ok=True)

    def update(self, video_id, scores, labels, boxes=None, masks=None):
        self.records.extend(
            prepare_video_predictions(video_id, scores, labels, boxes, masks)
        )

    def add_records(self, records: List[Dict]):
        self.records.extend(records)

    def _shard_path(self, rank: int) -> str:
        return f"{self.dump_file}.shard{rank}"

    def write_shard(self, rank: int = 0) -> str:
        path = self._shard_path(rank)
        with open(path, "w") as f:
            json.dump(self.records, f)
        return path

    def finalize(self, gt, num_shards: int = 1, **kwargs):
        """Merge shard files (falling back to in-memory records when none
        were written), dump, evaluate, write metrics. Returns the meters."""
        shard_lists = []
        for r in range(num_shards):
            p = self._shard_path(r)
            if os.path.exists(p):
                with open(p) as f:
                    shard_lists.append(json.load(f))
        if not shard_lists:
            shard_lists = [self.records]
        merged = dedup_video_predictions(shard_lists)
        with open(self.dump_file, "w") as f:
            json.dump(merged, f)
        meters, np_rows = evaluate_saco_veval(
            gt, merged, self.evaluators, self.dataset_name, **kwargs
        )
        with open(self.eval_metrics_file, "w") as f:
            json.dump(
                {"dataset_level_metrics": meters, "video_np_level_metrics": np_rows},
                f,
            )
        return meters
