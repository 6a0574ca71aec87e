"""Agent-tier prediction-manipulation helpers (the port's own copy of
``sam3_lora_tpu/agent_helpers.py``, which imports no JAX).

Host-side utilities the MLLM agent loop uses to post-process grounding
results between LLM turns (reference: ``sam3/agent/helpers/`` — a vendored
detectron2 subset). These operate on small per-image prediction sets (JSON
dicts, a few dozen instances), so the design keeps them as plain
numpy on the host: shipping a 20-instance dedup to the device would cost more
in transfer + dispatch than the compute. Batched on-device equivalents for
the *training* path live in ``ops/masks.py`` / ``ops/boxes.py``.

Coverage vs the reference helper files:

* ``mask_overlap_removal.py``      -> ``mask_iom`` / ``remove_overlapping_masks``
* ``boxes.py`` (BoxMode, pairwise) -> ``convert_box_mode``, ``pairwise_iou`` /
                                      ``pairwise_ioa`` / ``matched_pairwise_iou`` /
                                      ``pairwise_point_box_distance``
* ``rotated_boxes.py``             -> ``rotated_box_corners``,
                                      ``pairwise_iou_rotated`` (exact convex
                                      clipping instead of the CUDA extension)
* ``keypoints.py``                 -> ``keypoints_to_heatmap`` /
                                      ``heatmaps_to_keypoints``
* ``memory.py`` (CUDA OOM retry)   -> not carried over (the JAX package's
                                      XLA preallocates, so it had none to copy)
* ``rle.py`` / ``roi_align.py``    -> already covered by ``ops/rle.py`` and
                                      ``ops/sampling.py::roi_align``
* ``visualizer.py``/``som_utils.py``/``color_map.py``/``zoom_in.py`` ->
  covered by ``viz.py`` (overlays, set-of-marks, zoom_to_box, palettes).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "BoxMode",
    "convert_box_mode",
    "mask_intersection",
    "mask_iom",
    "remove_overlapping_masks",
    "pairwise_iou",
    "pairwise_ioa",
    "matched_pairwise_iou",
    "pairwise_point_box_distance",
    "rotated_box_corners",
    "pairwise_iou_rotated",
    "keypoints_to_heatmap",
    "heatmaps_to_keypoints",
]


# --------------------------------------------------------------------- #
# box modes (helpers/boxes.py:15-134)
# --------------------------------------------------------------------- #
class BoxMode(IntEnum):
    """Box coordinate conventions (absolute pixel coordinates unless REL)."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3
    XYWHA_ABS = 4  # (cx, cy, w, h, angle_degrees_ccw)


def convert_box_mode(
    box: np.ndarray,
    from_mode: BoxMode,
    to_mode: BoxMode,
    image_size: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Convert (..., 4|5) boxes between modes (helpers/boxes.py:44-134).

    REL modes need ``image_size=(h, w)``. XYWHA converts to/from the other
    modes via its axis-aligned bounding box only when angle == 0 (same
    restriction as the reference's assert).
    """
    b = np.asarray(box, np.float64).copy()
    if from_mode == to_mode:
        return b

    def _to_abs_xyxy(b, mode):
        if mode == BoxMode.XYXY_ABS:
            return b
        if mode == BoxMode.XYWH_ABS:
            out = b.copy()
            out[..., 2] = b[..., 0] + b[..., 2]
            out[..., 3] = b[..., 1] + b[..., 3]
            return out
        if mode in (BoxMode.XYXY_REL, BoxMode.XYWH_REL):
            if image_size is None:
                raise ValueError("relative modes require image_size=(h, w)")
            h, w = image_size
            scale = np.array([w, h, w, h], np.float64)
            return _to_abs_xyxy(
                b * scale,
                BoxMode.XYXY_ABS if mode == BoxMode.XYXY_REL else BoxMode.XYWH_ABS,
            )
        if mode == BoxMode.XYWHA_ABS:
            if not np.allclose(b[..., 4], 0.0):
                raise ValueError(
                    "XYWHA -> axis-aligned conversion only defined for angle=0"
                )
            cx, cy, ww, hh = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
            return np.stack(
                [cx - ww / 2, cy - hh / 2, cx + ww / 2, cy + hh / 2], axis=-1
            )
        raise ValueError(f"unsupported from_mode {mode}")

    xyxy = _to_abs_xyxy(b, from_mode)
    if to_mode == BoxMode.XYXY_ABS:
        return xyxy
    if to_mode == BoxMode.XYWH_ABS:
        out = xyxy.copy()
        out[..., 2] = xyxy[..., 2] - xyxy[..., 0]
        out[..., 3] = xyxy[..., 3] - xyxy[..., 1]
        return out
    if to_mode in (BoxMode.XYXY_REL, BoxMode.XYWH_REL):
        if image_size is None:
            raise ValueError("relative modes require image_size=(h, w)")
        h, w = image_size
        scale = np.array([w, h, w, h], np.float64)
        abs_out = convert_box_mode(
            xyxy,
            BoxMode.XYXY_ABS,
            BoxMode.XYXY_ABS if to_mode == BoxMode.XYXY_REL else BoxMode.XYWH_ABS,
        )
        return abs_out / scale
    if to_mode == BoxMode.XYWHA_ABS:
        cx = (xyxy[..., 0] + xyxy[..., 2]) / 2
        cy = (xyxy[..., 1] + xyxy[..., 3]) / 2
        ww = xyxy[..., 2] - xyxy[..., 0]
        hh = xyxy[..., 3] - xyxy[..., 1]
        return np.stack([cx, cy, ww, hh, np.zeros_like(cx)], axis=-1)
    raise ValueError(f"unsupported to_mode {to_mode}")


# --------------------------------------------------------------------- #
# mask overlap removal (helpers/mask_overlap_removal.py)
# --------------------------------------------------------------------- #
def _as_bool_masks(masks, h: Optional[int] = None, w: Optional[int] = None):
    """List of (H, W) arrays / nested lists / COCO RLE dicts -> (N, H, W) bool."""
    out = []
    for m in masks:
        if isinstance(m, dict) and "counts" in m:
            from .ops.rle import rle_decode

            out.append(rle_decode(m).astype(bool))
        else:
            arr = np.asarray(m)
            if arr.ndim != 2:
                raise ValueError("mask must be 2D (H, W)")
            out.append(arr > 0)
    if not out:
        return np.zeros((0, h or 0, w or 0), bool)
    return np.stack(out, axis=0)


def mask_intersection(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """(N, H, W) x (M, H, W) bool -> (N, M) int64 intersection areas.

    Bit-packs rows so the pairwise AND runs 8 pixels per byte op (the
    reference blocks the torch broadcast instead, :14-27)."""
    n, m = len(masks1), len(masks2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.int64)
    p1 = np.packbits(masks1.reshape(n, -1), axis=-1)
    p2 = np.packbits(masks2.reshape(m, -1), axis=-1)
    out = np.zeros((n, m), np.int64)
    popcount = np.unpackbits(
        np.arange(256, dtype=np.uint8)[:, None], axis=1
    ).sum(1)
    for i in range(n):
        out[i] = popcount[p1[i][None, :] & p2].sum(axis=-1)
    return out


def mask_iom(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Intersection over MINIMUM area, (N, M) float32 (:30-37)."""
    inter = mask_intersection(masks1, masks2).astype(np.float64)
    a1 = masks1.reshape(len(masks1), -1).sum(-1)
    a2 = masks2.reshape(len(masks2), -1).sum(-1)
    min_area = np.maximum(np.minimum(a1[:, None], a2[None, :]), 1)
    return (inter / (min_area + 1e-8)).astype(np.float32)


def remove_overlapping_masks(sample: Dict, iom_thresh: float = 0.3) -> Dict:
    """Greedy IoM dedup over a prediction dict (:71-128): sort by score
    descending, keep a mask iff its IoM against every kept mask is <=
    threshold. With 0 or 1 masks the sample is returned unchanged (no extra
    keys, same as the reference's early-exit contract)."""
    if "pred_masks" not in sample or not isinstance(sample["pred_masks"], list):
        return sample
    pred_masks = sample["pred_masks"]
    n = len(pred_masks)
    if n <= 1:
        return sample

    h = int(sample["orig_img_h"])
    w = int(sample["orig_img_w"])
    scores = list(sample.get("pred_scores", [1.0] * n))
    boxes = sample.get("pred_boxes")
    if len(scores) != n or (boxes is not None and len(boxes) != n):
        raise ValueError("pred_masks/pred_scores/pred_boxes length mismatch")

    masks = _as_bool_masks(pred_masks, h, w)
    iom = mask_iom(masks, masks)
    order = sorted(range(n), key=lambda i: float(scores[i]), reverse=True)
    kept: List[int] = []
    for i in order:
        if all(iom[i, j] <= iom_thresh for j in kept):
            kept.append(i)
    kept_sorted = sorted(kept)

    out = dict(sample)
    out["pred_masks"] = [pred_masks[i] for i in kept_sorted]
    out["pred_scores"] = [scores[i] for i in kept_sorted]
    if boxes is not None:
        out["pred_boxes"] = [boxes[i] for i in kept_sorted]
    out["kept_indices"] = kept_sorted
    out["removed_indices"] = [i for i in range(n) if i not in set(kept_sorted)]
    out["iom_threshold"] = float(iom_thresh)
    return out


# --------------------------------------------------------------------- #
# pairwise axis-aligned box ops (helpers/boxes.py:325-430)
# --------------------------------------------------------------------- #
def _pairwise_intersection(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    tl = np.maximum(b1[:, None, :2], b2[None, :, :2])
    br = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    return wh[..., 0] * wh[..., 1]


def _areas(b: np.ndarray) -> np.ndarray:
    return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)


def pairwise_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU; zero-area pairs give 0 (:349-371)."""
    b1 = np.asarray(boxes1, np.float64).reshape(-1, 4)
    b2 = np.asarray(boxes2, np.float64).reshape(-1, 4)
    inter = _pairwise_intersection(b1, b2)
    union = _areas(b1)[:, None] + _areas(b2)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0).astype(
        np.float32
    )


def pairwise_ioa(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Intersection over the SECOND set's areas (:374-391)."""
    b1 = np.asarray(boxes1, np.float64).reshape(-1, 4)
    b2 = np.asarray(boxes2, np.float64).reshape(-1, 4)
    inter = _pairwise_intersection(b1, b2)
    a2 = _areas(b2)[None, :]
    return np.where(a2 > 0, inter / np.maximum(a2, 1e-12), 0.0).astype(np.float32)


def matched_pairwise_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Elementwise IoU of aligned (N, 4) box lists (:413-430)."""
    b1 = np.asarray(boxes1, np.float64).reshape(-1, 4)
    b2 = np.asarray(boxes2, np.float64).reshape(-1, 4)
    if b1.shape != b2.shape:
        raise ValueError("matched_pairwise_iou needs equal-length box lists")
    tl = np.maximum(b1[:, :2], b2[:, :2])
    br = np.minimum(b1[:, 2:], b2[:, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    union = _areas(b1) + _areas(b2) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0).astype(
        np.float32
    )


def pairwise_point_box_distance(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 2) points x (M, 4) xyxy -> (P, M, 4) signed distances to
    (left, top, right, bottom); all four positive iff inside (:394-410)."""
    p = np.asarray(points, np.float64).reshape(-1, 2)
    b = np.asarray(boxes, np.float64).reshape(-1, 4)
    left = p[:, None, 0] - b[None, :, 0]
    top = p[:, None, 1] - b[None, :, 1]
    right = b[None, :, 2] - p[:, None, 0]
    bottom = b[None, :, 3] - p[:, None, 1]
    return np.stack([left, top, right, bottom], axis=-1).astype(np.float32)


# --------------------------------------------------------------------- #
# rotated boxes (helpers/rotated_boxes.py)
# --------------------------------------------------------------------- #
def rotated_box_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) XYWHA (angle degrees CCW) -> (N, 4, 2) corner coordinates in
    CCW order (rotated_boxes.py:177-214 convention: y axis points down, so a
    CCW rotation of the box appears clockwise in image space)."""
    b = np.asarray(boxes, np.float64).reshape(-1, 5)
    cx, cy, w, h, a = b.T
    theta = np.deg2rad(a)
    c, s = np.cos(theta), np.sin(theta)
    # corner offsets in box frame, CCW starting at (+w/2, +h/2)
    dx = np.stack([w / 2, -w / 2, -w / 2, w / 2], axis=-1)  # (N, 4)
    dy = np.stack([h / 2, h / 2, -h / 2, -h / 2], axis=-1)
    # y-down image frame: rotation by +a CCW maps (x, y) -> (x c + y s, -x s + y c)
    xs = cx[:, None] + dx * c[:, None] + dy * s[:, None]
    ys = cy[:, None] - dx * s[:, None] + dy * c[:, None]
    return np.stack([xs, ys], axis=-1)


def _polygon_area(poly: np.ndarray, nv: int) -> float:
    """Shoelace area of the first nv vertices (positive for CCW in y-up)."""
    if nv < 3:
        return 0.0
    x, y = poly[:nv, 0], poly[:nv, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def _clip_convex(subject: np.ndarray, ns: int, a: np.ndarray, b: np.ndarray):
    """Sutherland–Hodgman: clip polygon (subject[:ns]) by the half-plane on
    the interior side of directed edge a->b of a counter-clockwise clipper
    (cross((b-a), (p-a)) >= 0). Returns (clipped (16, 2), count)."""
    out = np.zeros((16, 2), np.float64)
    m = 0
    ex, ey = b[0] - a[0], b[1] - a[1]

    def side(p):
        return ex * (p[1] - a[1]) - ey * (p[0] - a[0])

    for i in range(ns):
        p = subject[i]
        q = subject[(i + 1) % ns]
        sp, sq = side(p), side(q)
        if sp >= 0:  # p inside (or on edge)
            out[m] = p
            m += 1
        if (sp > 0) != (sq > 0) and sp != sq:
            t = sp / (sp - sq)
            out[m] = p + t * (q - p)
            m += 1
    return out, m


def pairwise_iou_rotated(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) XYWHA -> (N, M) exact IoU via convex polygon clipping
    (replaces the reference's detectron2 CUDA/C++ extension,
    rotated_boxes.py:15-31). Host-side numpy: the agent tier calls this on a
    handful of boxes per image."""
    b1 = np.asarray(boxes1, np.float64).reshape(-1, 5)
    b2 = np.asarray(boxes2, np.float64).reshape(-1, 5)
    c1 = rotated_box_corners(b1)
    c2 = rotated_box_corners(b2)
    a1 = b1[:, 2] * b1[:, 3]
    a2 = b2[:, 2] * b2[:, 3]
    out = np.zeros((len(b1), len(b2)), np.float32)
    for i in range(len(b1)):
        for j in range(len(b2)):
            poly = np.zeros((16, 2), np.float64)
            poly[:4] = c2[j]
            nv = 4
            for e in range(4):
                poly, nv = _clip_convex(poly, nv, c1[i][e], c1[i][(e + 1) % 4])
                if nv == 0:
                    break
            inter = _polygon_area(poly, nv)
            union = a1[i] + a2[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out


# --------------------------------------------------------------------- #
# keypoints (helpers/keypoints.py:110-243)
# --------------------------------------------------------------------- #
def keypoints_to_heatmap(
    keypoints: np.ndarray, rois: np.ndarray, heatmap_size: int
):
    """(N, K, 3) keypoints (x, y, vis) + (N, 4) xyxy rois -> integer heatmap
    bin indices (N, K) and validity (N, K) (keypoints.py:110-167 semantics:
    out-of-roi or vis==0 keypoints are invalid; x == roi right edge maps to
    the last bin)."""
    kp = np.asarray(keypoints, np.float64)
    r = np.asarray(rois, np.float64).reshape(-1, 4)
    offset_x = r[:, 0][:, None]
    offset_y = r[:, 1][:, None]
    scale_x = heatmap_size / np.maximum(r[:, 2] - r[:, 0], 1e-6)[:, None]
    scale_y = heatmap_size / np.maximum(r[:, 3] - r[:, 1], 1e-6)[:, None]

    x = (kp[..., 0] - offset_x) * scale_x
    y = (kp[..., 1] - offset_y) * scale_y
    x = np.floor(x).astype(np.int64)
    y = np.floor(y).astype(np.int64)
    # right/bottom edge belongs to the last bin
    x_edge = kp[..., 0] == r[:, 2][:, None]
    y_edge = kp[..., 1] == r[:, 3][:, None]
    x = np.where(x_edge, heatmap_size - 1, x)
    y = np.where(y_edge, heatmap_size - 1, y)

    valid_loc = (x >= 0) & (y >= 0) & (x < heatmap_size) & (y < heatmap_size)
    vis = kp[..., 2] > 0
    valid = (valid_loc & vis).astype(np.int64)
    lin = y * heatmap_size + x
    return np.where(valid > 0, lin, 0), valid


def heatmaps_to_keypoints(maps: np.ndarray, rois: np.ndarray) -> np.ndarray:
    """(N, K, S, S) heatmaps + (N, 4) rois -> (N, K, 4) of
    (x, y, logit, prob) at each map's argmax, mapped back to image
    coordinates at bin centers (keypoints.py:170-243, nearest-bin variant
    without the bicubic upscale — the agent tier consumes coarse argmaxes)."""
    m = np.asarray(maps, np.float64)
    r = np.asarray(rois, np.float64).reshape(-1, 4)
    n, k, s, _ = m.shape
    widths = np.maximum(r[:, 2] - r[:, 0], 1e-6)
    heights = np.maximum(r[:, 3] - r[:, 1], 1e-6)

    flat = m.reshape(n, k, s * s)
    idx = flat.argmax(axis=-1)
    ys, xs = np.divmod(idx, s)
    logit = np.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    # softmax probability of the argmax bin
    e = np.exp(flat - flat.max(axis=-1, keepdims=True))
    prob = np.take_along_axis(
        e / e.sum(axis=-1, keepdims=True), idx[..., None], axis=-1
    )[..., 0]

    x_img = r[:, 0][:, None] + (xs + 0.5) * (widths[:, None] / s)
    y_img = r[:, 1][:, None] + (ys + 0.5) * (heights[:, None] / s)
    return np.stack([x_img, y_img, logit, prob], axis=-1).astype(np.float32)
