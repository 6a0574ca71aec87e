"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference works out, held to a limit of the
cell's (``benchmark/limits/<workload>.json``).

Training (the first ``check_steps`` updates of the window's own call and
feed, which set-up runs):
* ``loss_gap``: the largest |loss - reference| / |reference| of a step;
* ``grad_gap``: the first update's gradient as AdamW took it (its first
  moment over 1 - beta1), by the worst leaf: | |g| - |g_ref| | over the
  larger of |g_ref| and the median leaf's |g_ref|;
* ``update_gap``: the adapters' change over the steps, by the worst leaf,
  measured the same way;
* ``loss1_gap``, ``grad_median_gap``, ``update_median_gap``: the first
  step's loss, and the median leaf's gaps;
* ``presence_gap``: the largest relative gap of a step's presence-loss
  terms (every decoder layer's), which no matching touches.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both: their moves are round-off under Adam.

Serving (a seeded sample of the window's requests, with the longest):
the answers the program returned, kept queries in query order, are paired
with increasing reference queries at the least total score and box
distance (``align``); then
* ``score_gap``: the largest score difference of a matched answer, and
  the largest margin by which a reference query the program did not return
  lies above the threshold (or one it returned lies below);
* ``box_gap``: the largest box corner difference over the image's longer
  side;
* ``mask_gap``: the largest share of a matched mask's pixels, over its
  union with the reference's, on which the two differ;
* ``unmatched``: answers with no reference query within ``MATCH_SCORE``
  and ``MATCH_BOX`` (limit 0);
* ``mask_mean_gap``: the mean of the matched masks' gaps; and
  ``mask_sure_gap``: the worst mask's gap over the pixels the reference
  puts more than ``SURE`` from 0.5 (masks at the model's resolution), or,
  for masks resized to the image, over the pixels that only such
  low-resolution pixels reach through the resize.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

TINY_GRAD = 1e-3   # leaves under this share of the median leaf's gradient are left out
SURE = 0.1         # a mask pixel the reference puts this far from 0.5 is a sure one
MATCH_SCORE = 0.1  # a program answer pairs with a reference query within these
MATCH_BOX = 0.1


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> List[float]:
    """Each kept leaf's | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in keep}
    floor = statistics.median(norms.values()) if norms else 0.0
    return [abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n])
            / max(norms[n], floor, 1e-30) for n in keep]


def presence_terms(losses: Dict) -> Dict[str, float]:
    """The presence-loss terms of a step's loss dict (main and aux layers)."""
    return {k: float(v) for k, v in losses.items() if k.startswith("presence_loss")}


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {losses: [float], grad: {leaf: tensor},
    update: {leaf: tensor}}, on the CPU."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref["grad"].items()}
    med = statistics.median(gnorm.values())
    keep = [n for n, v in gnorm.items() if v >= TINY_GRAD * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], keep)
    update = _leaf_gaps(prog["update"], ref["update"], keep)
    a, b = prog["losses"][0], ref["losses"][0]
    presence = max((abs(ps.get(k, float("inf")) - v) / max(abs(v), 1e-30)
                    for ps, rs in zip(prog["presence"], ref["presence"]) for k, v in rs.items()),
                   default=float("inf"))
    return {"loss_gap": loss, "loss1_gap": abs(a - b) / max(abs(b), 1e-30),
            "presence_gap": presence,
            "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
            "update_gap": max(update), "update_median_gap": statistics.median(update)}


def _corners(boxes: np.ndarray) -> np.ndarray:
    return np.asarray(boxes, np.float64).reshape(-1, 4)


def align(ps: np.ndarray, pb: np.ndarray, rs: np.ndarray, rb: np.ndarray, side: float):
    """The program's answers are kept queries in query order: pair answer j
    with reference query q[j], q increasing, at the least total distance
    (score gap over ``MATCH_SCORE`` plus box gap over ``MATCH_BOX``)."""
    n, m = len(ps), len(rs)
    if n == 0:
        return []
    if n > m:
        return [None] * n
    cost = (np.abs(ps[:, None] - rs[None, :]) / MATCH_SCORE
            + np.abs(pb[:, None, :] - rb[None, :, :]).max(-1) / side / MATCH_BOX)
    best = np.full((n, m), np.inf)
    best[0] = cost[0]
    arg = np.zeros((n, m), np.int64)
    for j in range(1, n):
        run, at = np.inf, 0  # the best alignment of answers < j ending before q
        for q in range(1, m):
            if best[j - 1, q - 1] < run:
                run, at = best[j - 1, q - 1], q - 1
            best[j, q], arg[j, q] = cost[j, q] + run, at
    q = int(np.argmin(best[-1]))
    out = [q]
    for j in range(n - 1, 0, -1):
        q = int(arg[j, q])
        out.append(q)
    return out[::-1]


def match_answers(prog: Dict, ref: Dict, threshold: float, hw) -> Dict[str, float]:
    """One prompt: the program's answers (scores, boxes, masks) against the
    reference's ``answers`` (with ``all_scores`` and ``all_boxes``, every
    query's, in query order)."""
    side = float(max(hw))
    ps = np.asarray(prog["scores"] if prog["scores"] is not None else [], np.float64)
    pb = _corners(prog["boxes"] if prog["boxes"] is not None else np.zeros((0, 4)))
    pm = prog["masks"] if prog["masks"] is not None else np.zeros((0, 1, 1), bool)
    rs, rb = np.asarray(ref["all_scores"], np.float64), _corners(ref["all_boxes"])
    kept = np.flatnonzero(rs > threshold)
    ref_mask = {int(q): m for q, m in zip(kept, ref["masks"])}
    out = {"score_gap": 0.0, "box_gap": 0.0, "mask_gap": 0.0, "unmatched": 0.0,
           "mask_sum": 0.0, "masks": 0.0}
    if "probs" in ref or "sure" in ref:
        out["mask_sure_gap"] = 0.0
        sure_of = ({int(q): m for q, m in zip(kept, ref["sure"])} if "sure" in ref else
                   {int(q): np.abs(p - 0.5) > SURE for q, p in zip(kept, ref["probs"])})
    matched = set()
    for j, q in enumerate(align(ps, pb, rs, rb, side)):
        if q is None or (abs(rs[q] - ps[j]) > MATCH_SCORE
                         or np.abs(rb[q] - pb[j]).max() / side > MATCH_BOX):
            out["unmatched"] += 1
            continue
        matched.add(q)
        out["score_gap"] = max(out["score_gap"], float(abs(rs[q] - ps[j])))
        out["box_gap"] = max(out["box_gap"], float(np.abs(rb[q] - pb[j]).max() / side))
        if q in ref_mask:
            a, b = np.asarray(pm[j], bool), ref_mask[q]
            if a.shape != b.shape:
                out["mask_gap"] = 1.0
                continue
            gap = float(np.logical_xor(a, b).sum() / max(np.logical_or(a, b).sum(), 1))
            out["mask_gap"] = max(out["mask_gap"], gap)
            if "mask_sure_gap" in out:
                sure = sure_of[q]
                out["mask_sure_gap"] = max(out["mask_sure_gap"], float(
                    (np.logical_xor(a, b) & sure).sum() / max((np.logical_or(a, b) & sure).sum(), 1)))
            out["mask_sum"] += gap
            out["masks"] += 1
        else:  # returned, though the reference keeps it not: by how much below
            out["score_gap"] = max(out["score_gap"], float(threshold - rs[q]))
    for qi in kept:  # kept by the reference, not returned: by how much above
        if int(qi) not in matched:
            out["score_gap"] = max(out["score_gap"], float(rs[qi] - threshold))
    return out


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst gap of each kind over prompts, the sum of ``unmatched``, and
    ``mask_mean_gap``, the mean gap of the matched masks."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            summed = k in ("unmatched", "mask_sum", "masks")
            out[k] = out.get(k, 0.0) + v if summed else max(out.get(k, 0.0), v)
    out["mask_mean_gap"] = out.pop("mask_sum", 0.0) / max(out.pop("masks", 0.0), 1.0)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's limits name at or under its limit (the other
    readings are reported, not compared); a limit without a reading is a
    fault of the harness."""
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return all(np.isfinite(readings[k]) and readings[k] <= limits[k] for k in limits)
