"""Video tracking evaluation: HOTA, CLEAR-MOT and YTVIS-style track mAP.

TPU-build replacement for the reference's vendored evaluation toolkits
(``sam3/eval/``: HOTA via trackeval, TETA, ``ytvis_eval.py`` 411 LoC,
``saco_veval_*``): the headline tracking metrics are re-derived from their
published definitions rather than ported, and operate on simple in-memory
track dicts (no file-format plumbing):

  gt_tracks / pred_tracks: {track_id: {frame_idx: mask (H,W) bool
                                       or box [x1,y1,x2,y2]}}
  pred_scores: {track_id: float}  (track confidence, for mAP sweeps)

* HOTA (Luiten et al., IJCV 2021): HOTA_alpha = sqrt(DetA * AssA) averaged
  over 19 alpha thresholds 0.05..0.95; the exact trackeval algorithm (one
  Hungarian per frame on global-alignment-weighted similarity), cross-checked
  against the reference's vendored toolkit.
* CLEAR-MOT (MOTA/MOTP, Bernardin & Stiefelhagen 2008): per-frame greedy
  matching with persistence, counting misses / false positives / id
  switches.
* Track mAP (YTVIS protocol): spatio-temporal track IoU (sum of per-frame
  intersections / sum of unions over the union of frames), 101-point
  interpolated AP over IoU 0.5:0.95.

The PyTorch port's copy of ``sam3_lora_tpu/eval/video_eval.py`` (numpy and
scipy, no JAX); ``tests/test_torch_video_eval.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "evaluate_hota",
    "evaluate_clear_mot",
    "evaluate_track_map",
    "evaluate_teta",
    "track_iou",
]


def _iou(a, b) -> float:
    """IoU of two detections: (H,W) bool masks or xyxy boxes."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim == 2:  # masks
        inter = np.logical_and(a, b).sum()
        union = np.logical_or(a, b).sum()
        return float(inter) / float(union) if union else 0.0
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / ua) if ua > 0 else 0.0


def _frames(tracks: Dict) -> List:
    fs = set()
    for t in tracks.values():
        fs.update(t.keys())
    return sorted(fs)


def _lsap_max(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Max-sum linear assignment (scipy)."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(-cost)


def track_iou(ta: Dict, tb: Dict) -> float:
    """Spatio-temporal track IoU (YTVIS): sum_t |A_t ∩ B_t| / sum_t |A_t ∪ B_t|
    over the union of both tracks' frames (absent frame = empty)."""
    frames = set(ta.keys()) | set(tb.keys())
    inter_sum = 0.0
    union_sum = 0.0
    for f in frames:
        a, b = ta.get(f), tb.get(f)
        d = a if a is not None else b
        if np.asarray(d).ndim == 2:  # masks
            am = np.asarray(a, bool) if a is not None else np.zeros_like(np.asarray(d), bool)
            bm = np.asarray(b, bool) if b is not None else np.zeros_like(am)
            inter_sum += np.logical_and(am, bm).sum()
            union_sum += np.logical_or(am, bm).sum()
        elif a is not None and b is not None:  # boxes
            i = _iou(a, b)
            aa = (a[2] - a[0]) * (a[3] - a[1])
            bb = (b[2] - b[0]) * (b[3] - b[1])
            inter = i / (1 + i) * (aa + bb) if i > 0 else 0.0  # from IoU identity
            inter_sum += inter
            union_sum += aa + bb - inter
        elif a is not None or b is not None:
            d = a if a is not None else b
            union_sum += (d[2] - d[0]) * (d[3] - d[1])
    return inter_sum / union_sum if union_sum > 0 else 0.0


# ---------------------------------------------------------------------------
# HOTA
# ---------------------------------------------------------------------------


def evaluate_hota(
    gt_tracks: Dict,
    pred_tracks: Dict,
    alphas: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """HOTA = mean_alpha sqrt(DetA_a * AssA_a) — the official trackeval
    algorithm (Luiten et al., IJCV 2021), re-derived to agree exactly with
    the reference's vendored oracle
    (sam3/eval/hota_eval_toolkit/trackeval/metrics/hota.py:39-173, verified
    to 1e-12 by tests/test_eval_crosscheck.py over randomized workloads):

    1. Accumulate a GLOBAL (alpha-independent) alignment score per
       (gt_id, pred_id) track pair: per frame, each pair adds its
       "sim_iou" = sim / (rowsum + colsum - sim); the pair score is then
       Jaccard-normalized by track lengths.
    2. ONE Hungarian matching per frame on global_alignment * similarity
       (not one per alpha — association context breaks score ties).
    3. Per alpha, a matched pair counts as TP iff its similarity >= alpha;
       AssA_a re-scores only the MATCHED pair counts Jaccard-style.

    Returns scalar means over the 19 alphas (0.05..0.95) for the headline
    keys plus the full per-alpha arrays under ``*_array``.
    """
    alphas = np.asarray(alphas if alphas is not None else np.arange(0.05, 0.99, 0.05))
    gt_ids = sorted(gt_tracks.keys())
    pr_ids = sorted(pred_tracks.keys())
    n_gt, n_pr = len(gt_ids), len(pr_ids)
    frames = _frames({**{f"g{k}": v for k, v in gt_tracks.items()},
                      **{f"p{k}": v for k, v in pred_tracks.items()}})
    eps = np.finfo("float").eps

    # per-frame similarity matrices + presence index lists
    per_frame = []  # (gt_present_idx, pr_present_idx, sim_matrix)
    for f in frames:
        gi = [i for i, g in enumerate(gt_ids) if f in gt_tracks[g]]
        pi = [j for j, p in enumerate(pr_ids) if f in pred_tracks[p]]
        sim = np.zeros((len(gi), len(pi)))
        for a, i in enumerate(gi):
            for b, j in enumerate(pi):
                sim[a, b] = _iou(gt_tracks[gt_ids[i]][f], pred_tracks[pr_ids[j]][f])
        per_frame.append((np.asarray(gi, int), np.asarray(pi, int), sim))

    n_a = len(alphas)
    res = {k: np.zeros(n_a) for k in
           ("HOTA_TP", "HOTA_FN", "HOTA_FP", "LocA", "AssA", "AssRe", "AssPr")}
    num_gt_dets = sum(len(gi) for gi, _, _ in per_frame)
    num_pr_dets = sum(len(pi) for _, pi, _ in per_frame)
    if num_pr_dets == 0 or num_gt_dets == 0:
        res["HOTA_FN"] += num_gt_dets
        res["HOTA_FP"] += num_pr_dets
        res["LocA"] += 1.0
        return _hota_finalize(res, alphas)

    # pass 1: global alignment accumulation (alpha-independent)
    potential = np.zeros((n_gt, n_pr))
    gt_count = np.zeros((n_gt, 1))
    pr_count = np.zeros((1, n_pr))
    for gi, pi, sim in per_frame:
        denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
        sim_iou = np.zeros_like(sim)
        mask = denom > 0 + eps
        sim_iou[mask] = sim[mask] / denom[mask]
        potential[gi[:, None], pi[None, :]] += sim_iou
        gt_count[gi] += 1
        pr_count[0, pi] += 1
    global_alignment = potential / (gt_count + pr_count - potential)

    # pass 2: one Hungarian per frame; per-alpha thresholding of its matches
    matches_counts = [np.zeros((n_gt, n_pr)) for _ in range(n_a)]
    for gi, pi, sim in per_frame:
        if len(gi) == 0:
            res["HOTA_FP"] += len(pi)
            continue
        if len(pi) == 0:
            res["HOTA_FN"] += len(gi)
            continue
        score_mat = global_alignment[gi[:, None], pi[None, :]] * sim
        rows, cols = _lsap_max(score_mat)
        for a in range(n_a):
            ok = sim[rows, cols] >= alphas[a] - eps
            num = int(ok.sum())
            res["HOTA_TP"][a] += num
            res["HOTA_FN"][a] += len(gi) - num
            res["HOTA_FP"][a] += len(pi) - num
            if num:
                res["LocA"][a] += float(sim[rows[ok], cols[ok]].sum())
                matches_counts[a][gi[rows[ok]], pi[cols[ok]]] += 1

    # association scores from the MATCHED counts
    for a in range(n_a):
        mc = matches_counts[a]
        ass_a = mc / np.maximum(1, gt_count + pr_count - mc)
        res["AssA"][a] = (mc * ass_a).sum() / max(1, res["HOTA_TP"][a])
        ass_re = mc / np.maximum(1, gt_count)
        res["AssRe"][a] = (mc * ass_re).sum() / max(1, res["HOTA_TP"][a])
        ass_pr = mc / np.maximum(1, pr_count)
        res["AssPr"][a] = (mc * ass_pr).sum() / max(1, res["HOTA_TP"][a])
    res["LocA"] = np.maximum(1e-10, res["LocA"]) / np.maximum(1e-10, res["HOTA_TP"])
    return _hota_finalize(res, alphas)


def _hota_finalize(res: Dict, alphas: np.ndarray) -> Dict:
    """trackeval hota.py:251-267 final fields + scalar means over alphas."""
    res["DetRe"] = res["HOTA_TP"] / np.maximum(1, res["HOTA_TP"] + res["HOTA_FN"])
    res["DetPr"] = res["HOTA_TP"] / np.maximum(1, res["HOTA_TP"] + res["HOTA_FP"])
    res["DetA"] = res["HOTA_TP"] / np.maximum(
        1, res["HOTA_TP"] + res["HOTA_FN"] + res["HOTA_FP"])
    res["HOTA"] = np.sqrt(res["DetA"] * res["AssA"])
    res["OWTA"] = np.sqrt(res["DetRe"] * res["AssA"])
    out = {k + "_array": v for k, v in res.items()}
    out.update({k: float(np.mean(res[k])) for k in
                ("HOTA", "DetA", "AssA", "LocA", "DetRe", "DetPr",
                 "AssRe", "AssPr", "OWTA")})
    out["HOTA(0)"] = float(res["HOTA"][0])
    out["LocA(0)"] = float(res["LocA"][0])
    out["HOTALocA(0)"] = out["HOTA(0)"] * out["LocA(0)"]
    out["alphas"] = alphas
    return out


# ---------------------------------------------------------------------------
# CLEAR-MOT
# ---------------------------------------------------------------------------


def evaluate_clear_mot(
    gt_tracks: Dict,
    pred_tracks: Dict,
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """MOTA = 1 - (FN + FP + IDSW) / num_gt; MOTP = mean matched IoU.

    Persistent matching: a gt keeps its previous prediction while IoU stays
    >= threshold; remaining pairs matched hungarian per frame; an id change
    on a gt counts as an id switch.
    """
    frames = _frames({**{f"g{k}": v for k, v in gt_tracks.items()},
                      **{f"p{k}": v for k, v in pred_tracks.items()}})
    last_match: Dict = {}
    fn = fp = idsw = 0
    n_gt = 0
    iou_sum = 0.0
    n_match = 0
    for f in frames:
        g_here = [g for g in gt_tracks if f in gt_tracks[g]]
        p_here = [p for p in pred_tracks if f in pred_tracks[p]]
        n_gt += len(g_here)
        matches = {}
        used_p = set()
        # persistence pass
        for g in list(g_here):
            p = last_match.get(g)
            if p is not None and p in p_here:
                i = _iou(gt_tracks[g][f], pred_tracks[p][f])
                if i >= iou_threshold:
                    matches[g] = (p, i)
                    used_p.add(p)
        # hungarian on the rest
        g_rem = [g for g in g_here if g not in matches]
        p_rem = [p for p in p_here if p not in used_p]
        if g_rem and p_rem:
            iou = np.array(
                [[_iou(gt_tracks[g][f], pred_tracks[p][f]) for p in p_rem]
                 for g in g_rem]
            )
            rows, cols = _lsap_max(iou)
            for a, b in zip(rows, cols):
                if iou[a, b] >= iou_threshold:
                    g, p = g_rem[a], p_rem[b]
                    matches[g] = (p, iou[a, b])
                    used_p.add(p)
        for g, (p, i) in matches.items():
            prev = last_match.get(g)
            if prev is not None and prev != p:
                idsw += 1
            last_match[g] = p
            iou_sum += i
            n_match += 1
        fn += len(g_here) - len(matches)
        fp += len(p_here) - len(used_p)
    mota = 1.0 - (fn + fp + idsw) / n_gt if n_gt else 0.0
    motp = iou_sum / n_match if n_match else 0.0
    return {"MOTA": float(mota), "MOTP": float(motp), "IDSW": float(idsw),
            "FN": float(fn), "FP": float(fp)}


# ---------------------------------------------------------------------------
# Track mAP (YTVIS protocol)
# ---------------------------------------------------------------------------


def evaluate_track_map(
    gt_tracks: Dict,
    pred_tracks: Dict,
    pred_scores: Dict,
    iou_thrs: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """Class-agnostic track-level AP over spatio-temporal IoU thresholds
    (ytvis_eval.py protocol on one video; callers average across videos)."""
    iou_thrs = np.asarray(iou_thrs if iou_thrs is not None else np.linspace(0.5, 0.95, 10))
    recall_thrs = np.linspace(0, 1, 101)
    gt_ids = sorted(gt_tracks.keys())
    pr_ids = sorted(pred_tracks.keys(), key=lambda p: -pred_scores.get(p, 0.0))
    if not gt_ids:
        return {"track_mAP": 0.0, "track_mAP_50": 0.0, "track_mAP_75": 0.0}
    iou = np.array(
        [[track_iou(pred_tracks[p], gt_tracks[g]) for g in gt_ids] for p in pr_ids]
    ) if pr_ids else np.zeros((0, len(gt_ids)))

    aps = []
    for t_i, thr in enumerate(iou_thrs):
        gt_taken = np.zeros(len(gt_ids), bool)
        tp = np.zeros(len(pr_ids))
        for d in range(len(pr_ids)):  # greedy best-IoU match, score order
            best, best_g = thr, -1
            for g in range(len(gt_ids)):
                if not gt_taken[g] and iou[d, g] >= best:
                    best, best_g = iou[d, g], g
            if best_g >= 0:
                gt_taken[best_g] = True
                tp[d] = 1
        cum_tp = np.cumsum(tp)
        recall = cum_tp / len(gt_ids)
        precision = cum_tp / (np.arange(len(pr_ids)) + 1)
        # monotone precision envelope
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        ap = 0.0
        for r in recall_thrs:
            idx = np.searchsorted(recall, r, side="left")
            if idx < len(precision):
                ap += precision[idx]
        aps.append(ap / len(recall_thrs))
    aps = np.asarray(aps)
    return {
        "track_mAP": float(aps.mean()),
        "track_mAP_50": float(aps[np.argmin(np.abs(iou_thrs - 0.5))]),
        "track_mAP_75": float(aps[np.argmin(np.abs(iou_thrs - 0.75))]),
    }

# ---------------------------------------------------------------------------
# TETA (Track Every Thing Accuracy)
# ---------------------------------------------------------------------------


def _teta_build_data(gt_tracks: Dict, pred_tracks: Dict) -> Dict:
    """Build the TETA toolkit-shaped ``data`` dict for ONE single-class
    sequence from in-memory tracks.

    The reference vendors only the TETA *metric* class
    (sam3/eval/teta_eval_toolkit/metrics/teta.py, 419 LoC); the toolkit's
    ``datasets`` preprocessing module is missing from the vendored package
    (``teta_eval_toolkit/__init__.py:4`` imports it, so the reference's own
    saco_veval TETA path cannot even import as shipped). This builder
    therefore re-derives the preprocessing from the metric's consumption of
    the dict and the TETA paper (Li et al., ECCV 2022): tracker dets that
    overlap NO ground truth at a timestep are excluded from the localization
    false-positive pool (``tk_overlap_ids``) — TETA never punishes
    localization for detections outside the evaluated class's neighbourhood.
    The metric math downstream of this dict is cross-validated at 1e-12
    against the vendored class by tests/test_eval_crosscheck.py.
    """
    gt_keys = sorted(gt_tracks.keys())
    pr_keys = sorted(pred_tracks.keys())
    frames = _frames({**{f"g{k}": v for k, v in gt_tracks.items()},
                      **{f"p{k}": v for k, v in pred_tracks.items()}})
    data: Dict = {
        "num_timesteps": len(frames),
        "num_gt_ids": len(gt_keys),
        "num_tk_ids": len(pr_keys),
        "gt_id_map": {i: k for i, k in enumerate(gt_keys)},
        "tk_id_map": {i: k for i, k in enumerate(pr_keys)},
        "gt_ids": [], "tk_ids": [], "tk_overlap_ids": [],
        "tk_class_eval_tk_ids": [], "sim_scores": [],
        "gt_classes": [], "tk_classes": [],
    }
    num_gt_dets = num_tk_overlap_dets = num_tk_cls_dets = 0
    for f in frames:
        gi = np.asarray([i for i, g in enumerate(gt_keys) if f in gt_tracks[g]], int)
        pi = np.asarray([j for j, p in enumerate(pr_keys) if f in pred_tracks[p]], int)
        sim = np.zeros((len(gi), len(pi)))
        for a, i in enumerate(gi):
            for b, j in enumerate(pi):
                sim[a, b] = _iou(gt_tracks[gt_keys[i]][f], pred_tracks[pr_keys[j]][f])
        overlap = pi[sim.max(axis=0) > 0] if len(gi) and len(pi) else pi[:0]
        data["gt_ids"].append(gi)
        data["tk_ids"].append(pi)
        data["tk_overlap_ids"].append(overlap)
        data["tk_class_eval_tk_ids"].append(pi)
        data["sim_scores"].append(sim)
        data["gt_classes"].append(1)                       # single class
        data["tk_classes"].append(np.ones(len(pi), int))
        num_gt_dets += len(gi)
        num_tk_overlap_dets += len(overlap)
        num_tk_cls_dets += len(pi)
    data["num_gt_dets"] = num_gt_dets
    data["num_tk_overlap_dets"] = num_tk_overlap_dets
    data["num_tk_cls_dets"] = num_tk_cls_dets
    return data


def _teta_finalize(res: Dict) -> Dict:
    """teta.py:363-391 _compute_final_fields (single sequence)."""
    res["LocRe"] = res["Loc_TP"] / np.maximum(1, res["Loc_TP"] + res["Loc_FN"])
    res["LocPr"] = res["Loc_TP"] / np.maximum(1, res["Loc_TP"] + res["Loc_FP"])
    res["LocA"] = res["Loc_TP"] / np.maximum(
        1, res["Loc_TP"] + res["Loc_FN"] + res["Loc_FP"])
    cls_re = res["Cls_TP"] / np.maximum(1, res["Cls_TP"] + res["Cls_FN"])
    cls_pr = res["Cls_TP"] / np.maximum(1, res["Cls_TP"] + res["Cls_FP"])
    cls_a = res["Cls_TP"] / np.maximum(
        1, res["Cls_TP"] + res["Cls_FN"] + res["Cls_FP"])
    res["ClsRe"] = np.mean(cls_re)
    res["ClsPr"] = np.mean(cls_pr)
    res["ClsA"] = np.mean(cls_a)
    res["TETA"] = (res["LocA"] + res["AssocA"] + res["ClsA"]) / 3
    return res


def evaluate_teta(
    gt_tracks: Dict,
    pred_tracks: Dict,
    thr: int = 50,
) -> Dict[str, float]:
    """TETA (Li et al., ECCV 2022) for one single-class sequence: the mean
    over 20 alpha labels (0.00..0.95) of (LocA + AssocA + ClsA)/3, where
    localization false positives are restricted to tracker dets overlapping
    some GT with IoU >= thr/100 (teta.py:136), association re-scores matched
    pair counts Jaccard-style exactly like HOTA, and classification (trivial
    single-class here) counts matches at alpha >= 0.5.

    Matches the vendored oracle sam3/eval/teta_eval_toolkit/metrics/teta.py
    ``eval_sequence_single_thr`` (exhaustive=False) field-for-field — see
    tests/test_eval_crosscheck.py. Scalars are fractions (the toolkit's
    summary rows are 100x these, _base_metric.py:88-96).
    """
    eps = np.finfo("float").eps
    data = _teta_build_data(gt_tracks, pred_tracks)
    array_labels = np.arange(0.0, 0.99, 0.05)
    cls_labels = np.arange(0.5, 0.99, 0.05)
    n_a, n_c = len(array_labels), len(cls_labels)

    res: Dict = {}
    for f in ("Loc_TP", "Loc_FN", "Loc_FP"):
        res[f] = np.zeros(n_a)
    for f in ("Cls_TP", "Cls_FN", "Cls_FP"):
        res[f] = np.zeros(n_c)
    res["AssocA"] = np.zeros(n_a)
    res["AssocRe"] = np.zeros(n_a)
    res["AssocPr"] = np.zeros(n_a)

    def _scalars(r):
        out = {k + "_array": v for k, v in r.items()}
        for k in ("TETA", "LocA", "AssocA", "ClsA", "LocRe", "LocPr",
                  "AssocRe", "AssocPr", "ClsRe", "ClsPr"):
            out[k] = float(np.mean(r[k]))
        return out

    # empty-side early returns (teta.py:86-103)
    if data["num_tk_overlap_dets"] == 0:
        res["Loc_FN"] = data["num_gt_dets"] * np.ones(n_a)
        return _scalars(_teta_finalize(res))
    if data["num_gt_dets"] == 0:
        return _scalars(_teta_finalize(res))

    # global alignment score (teta.py:184-207), shared with the HOTA pass
    n_gt, n_tk = data["num_gt_ids"], data["num_tk_ids"]
    num_matches = np.zeros((n_gt, n_tk))
    gt_id_count = np.zeros((n_gt, 1))
    tk_id_count = np.zeros((1, n_tk))
    for gi, pi, sim in zip(data["gt_ids"], data["tk_ids"], data["sim_scores"]):
        denom = sim.sum(0, keepdims=True) + sim.sum(1, keepdims=True) - sim
        sim_iou = np.zeros_like(sim)
        mask = denom > 0 + eps
        sim_iou[mask] = sim[mask] / denom[mask]
        num_matches[gi[:, None], pi[None, :]] += sim_iou
        gt_id_count[gi] += 1
        tk_id_count[0, pi] += 1
    with np.errstate(invalid="ignore", divide="ignore"):
        ga_score = num_matches / (gt_id_count + tk_id_count - num_matches)

    matches_counts = [np.zeros_like(ga_score) for _ in array_labels]
    for t, (gt_ids_t, tk_ids_t, overlap_t) in enumerate(
        zip(data["gt_ids"], data["tk_ids"], data["tk_overlap_ids"])
    ):
        if len(gt_ids_t) == 0:
            continue
        sim = data["sim_scores"][t]
        score_mat = ga_score[gt_ids_t[:, None], tk_ids_t[None, :]] * sim
        rows, cols = _lsap_max(score_mat)

        # FP-L candidate pool: overlap dets with sim >= thr/100 (teta.py:130-141)
        if len(overlap_t) != 0:
            sorter = np.argsort(tk_ids_t)
            indexes = sorter[np.searchsorted(tk_ids_t, overlap_t, sorter=sorter)]
            sim_t = sim[:, indexes]
            fpl = overlap_t[(sim_t >= (thr / 100)).any(axis=0)]
            fpl_ori = set(data["tk_id_map"][tid] for tid in fpl)
        else:
            fpl_ori = set()

        for a, alpha in enumerate(array_labels):
            ok = sim[rows, cols] >= alpha - eps
            mrow, mcol = rows[ok], cols[ok]
            nm = len(mrow)
            matched_ori = set(data["tk_id_map"][tid] for tid in tk_ids_t[mcol])
            if alpha >= 0.5:
                # single class: every matched det is class-correct
                res["Cls_TP"][a - 10] += nm
            res["Loc_TP"][a] += nm
            res["Loc_FN"][a] += len(gt_ids_t) - nm
            res["Loc_FP"][a] += len(fpl_ori - matched_ori)
            if nm > 0:
                matches_counts[a][gt_ids_t[mrow], tk_ids_t[mcol]] += 1

    # association scores (teta.py:228-249)
    for a in range(n_a):
        mc = matches_counts[a]
        ass_a = mc / np.maximum(1, gt_id_count + tk_id_count - mc)
        res["AssocA"][a] = np.sum(mc * ass_a) / np.maximum(1, res["Loc_TP"][a])
        ass_re = mc / np.maximum(1, gt_id_count)
        res["AssocRe"][a] = np.sum(mc * ass_re) / np.maximum(1, res["Loc_TP"][a])
        ass_pr = mc / np.maximum(1, tk_id_count)
        res["AssocPr"][a] = np.sum(mc * ass_pr) / np.maximum(1, res["Loc_TP"][a])

    return _scalars(_teta_finalize(res))
