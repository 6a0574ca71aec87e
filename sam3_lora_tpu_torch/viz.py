"""Visualization helpers: mask/box overlays, color maps, set-of-marks (the
port's own copy of ``sam3_lora_tpu/viz.py``, which imports no JAX).

Re-design of the reference agent's visualization stack
(``sam3/agent/viz.py``, ``sam3/agent/helpers/visualizer.py`` +
``color_map.py`` / ``masks.py`` / ``som_utils.py`` / ``zoom_in.py``,
~4.6k LoC of matplotlib plumbing): the capabilities the agent loop and the
compare CLI actually consume — deterministic per-instance colors, alpha
mask overlay with contours, box + label drawing, set-of-marks numbering for
MLLM prompts, and crop-to-box zoom — implemented as pure numpy/PIL
functions that return uint8 images (no matplotlib dependency in the hot
path; callers save with PIL).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "instance_color",
    "overlay_masks",
    "draw_boxes",
    "draw_set_of_marks",
    "zoom_to_box",
    "side_by_side",
]

# Fixed qualitative palette (Detectron-style), cycled by instance index.
_PALETTE = np.array(
    [
        (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
        (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
        (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
        (152, 223, 138), (255, 152, 150), (197, 176, 213), (196, 156, 148),
    ],
    np.uint8,
)


def instance_color(idx: int) -> Tuple[int, int, int]:
    """Deterministic color for instance ``idx`` (color_map.py)."""
    return tuple(int(c) for c in _PALETTE[idx % len(_PALETTE)])


def _as_uint8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _mask_contour(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a bool mask (4-neighbour erosion difference)."""
    m = mask.astype(bool)
    interior = m.copy()
    interior[1:] &= m[:-1]
    interior[:-1] &= m[1:]
    interior[:, 1:] &= m[:, :-1]
    interior[:, :-1] &= m[:, 1:]
    return m & ~interior


def overlay_masks(
    image: np.ndarray,                    # (H, W, 3) uint8 or float [0,1]
    masks: Sequence[np.ndarray],          # list of (H, W) bool
    alpha: float = 0.45,
    colors: Optional[Sequence[Tuple[int, int, int]]] = None,
    contour: bool = True,
) -> np.ndarray:
    """Alpha-blend instance masks with per-instance colors + contours
    (helpers/visualizer.py draw_binary_mask path)."""
    out = _as_uint8(image).astype(np.float32)
    for i, mask in enumerate(masks):
        m = np.asarray(mask, bool)
        if m.shape != out.shape[:2]:
            from PIL import Image

            m = np.asarray(
                Image.fromarray(m.astype(np.uint8)).resize(
                    (out.shape[1], out.shape[0]), Image.NEAREST
                )
            ).astype(bool)
        c = np.array(
            colors[i] if colors is not None else instance_color(i), np.float32
        )
        out[m] = (1 - alpha) * out[m] + alpha * c
        if contour:
            out[_mask_contour(m)] = c
    return out.astype(np.uint8)


def draw_boxes(
    image: np.ndarray,
    boxes: Sequence[Sequence[float]],     # xyxy absolute
    labels: Optional[Sequence[str]] = None,
    scores: Optional[Sequence[float]] = None,
    colors: Optional[Sequence[Tuple[int, int, int]]] = None,
    width: int = 2,
) -> np.ndarray:
    """Rectangle + optional 'label score' text (visualizer draw_box)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(_as_uint8(image))
    d = ImageDraw.Draw(pil)
    for i, box in enumerate(boxes):
        c = tuple(colors[i]) if colors is not None else instance_color(i)
        x0, y0, x1, y1 = [float(v) for v in box]
        d.rectangle([x0, y0, x1, y1], outline=c, width=width)
        text = None
        if labels is not None:
            text = str(labels[i])
        if scores is not None:
            s = f"{float(scores[i]):.2f}"
            text = f"{text} {s}" if text else s
        if text:
            d.text((x0 + 2, max(0, y0 - 12)), text, fill=c)
    return np.asarray(pil)


def draw_set_of_marks(
    image: np.ndarray,
    masks: Sequence[np.ndarray],
    start_index: int = 1,
    alpha: float = 0.35,
) -> np.ndarray:
    """Set-of-marks prompt rendering (som_utils.py): overlay masks and stamp
    each instance's numeric id at its center of mass — the format MLLM
    agents consume to reference instances by number."""
    from PIL import Image, ImageDraw

    out = overlay_masks(image, masks, alpha=alpha)
    pil = Image.fromarray(out)
    d = ImageDraw.Draw(pil)
    for i, mask in enumerate(masks):
        m = np.asarray(mask, bool)
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            continue
        cy, cx = float(ys.mean()), float(xs.mean())
        tag = str(start_index + i)
        # dark disc + light numeral for contrast on any background
        r = 9
        d.ellipse([cx - r, cy - r, cx + r, cy + r], fill=(0, 0, 0))
        tw = 6 * len(tag)
        d.text((cx - tw / 2, cy - 6), tag, fill=(255, 255, 255))
    return np.asarray(pil)


def zoom_to_box(
    image: np.ndarray,
    box: Sequence[float],                 # xyxy absolute
    context: float = 0.2,
    out_size: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Crop around a box with relative context margin (zoom_in.py); returns
    (crop, actual xyxy window). Agents use this to inspect small objects."""
    img = _as_uint8(image)
    h, w = img.shape[:2]
    x0, y0, x1, y1 = [float(v) for v in box]
    mx = (x1 - x0) * context
    my = (y1 - y0) * context
    cx0 = int(max(0, np.floor(x0 - mx)))
    cy0 = int(max(0, np.floor(y0 - my)))
    cx1 = int(min(w, np.ceil(x1 + mx)))
    cy1 = int(min(h, np.ceil(y1 + my)))
    crop = img[cy0:cy1, cx0:cx1]
    if out_size is not None and crop.size:
        from PIL import Image

        crop = np.asarray(
            Image.fromarray(crop).resize((out_size, out_size), Image.BILINEAR)
        )
    return crop, (cx0, cy0, cx1, cy1)


def side_by_side(images: Sequence[np.ndarray], pad: int = 4) -> np.ndarray:
    """Horizontal comparison strip (compare CLI grids)."""
    imgs = [_as_uint8(im) for im in images]
    h = max(im.shape[0] for im in imgs)
    total_w = sum(im.shape[1] for im in imgs) + pad * (len(imgs) - 1)
    canvas = np.full((h, total_w, 3), 255, np.uint8)
    x = 0
    for im in imgs:
        canvas[: im.shape[0], x : x + im.shape[1]] = im
        x += im.shape[1] + pad
    return canvas
