"""Datapoint schema and the eval transform (host side, numpy): the port's own
copy of the part of ``sam3_lora_tpu/train/transforms.py`` that
``train/data.py`` uses.

A ``Datapoint`` is an image with its queries at native resolution; boxes are
absolute xyxy pixels. ``eval_transforms`` resizes to the model's square input
(PIL bilinear on uint8, nearest for masks) and emits CHW uint8, which the
ViT normalizes on the device (mean = std = 0.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Query:
    """One find-query: text (and/or geometric prompt) + its target objects."""

    text: str
    boxes: np.ndarray                     # (N, 4) float32 absolute xyxy
    masks: Optional[np.ndarray] = None    # (N, H, W) uint8/bool or None
    is_crowd: Optional[np.ndarray] = None  # (N,) bool
    is_exhaustive: bool = True
    # interactive-prompt inputs (optional)
    input_boxes: Optional[np.ndarray] = None   # (P, 4) absolute xyxy
    input_points: Optional[np.ndarray] = None  # (P, 2) absolute xy
    input_point_labels: Optional[np.ndarray] = None  # (P,) {1 pos, 0 neg}

    @property
    def num_objects(self) -> int:
        return int(self.boxes.shape[0])


@dataclass
class Datapoint:
    """Image + its queries, at native (pre-padding) resolution."""

    image: np.ndarray                     # (H, W, 3) uint8 or float32 [0,1]
    queries: List[Query] = field(default_factory=list)
    coco_image_id: int = -1
    original_size: Tuple[int, int] = (0, 0)  # (h, w) of the source image

    @property
    def size(self) -> Tuple[int, int]:
        return self.image.shape[0], self.image.shape[1]


def _as_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    if img.dtype == np.uint8:
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    arr = np.asarray(
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR
        )
    )
    return arr.astype(np.float32) / 255.0


def _resize_masks(masks: Optional[np.ndarray], h: int, w: int) -> Optional[np.ndarray]:
    if masks is None or masks.shape[0] == 0:
        if masks is None:
            return None
        return np.zeros((0, h, w), masks.dtype)
    from PIL import Image

    out = np.zeros((masks.shape[0], h, w), np.uint8)
    for i, m in enumerate(masks):
        out[i] = np.asarray(
            Image.fromarray(m.astype(np.uint8)).resize((w, h), Image.NEAREST)
        )
    return out


def resize_datapoint(
    dp: Datapoint,
    size: int,
    max_size: Optional[int] = None,
    square: bool = False,
) -> Datapoint:
    """Aspect-preserving shorter-side resize (or square)."""
    h, w = dp.size
    if square:
        nh = nw = size
    else:
        short, long = (h, w) if h <= w else (w, h)
        scale = size / short
        if max_size is not None and long * scale > max_size:
            scale = max_size / long
        nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        return dp
    sy, sx = nh / h, nw / w
    img = _resize_image(dp.image, nh, nw)
    queries = []
    for q in dp.queries:
        boxes = q.boxes * np.array([sx, sy, sx, sy], np.float32)
        kw = dict(
            boxes=boxes,
            masks=_resize_masks(q.masks, nh, nw),
        )
        if q.input_boxes is not None:
            kw["input_boxes"] = q.input_boxes * np.array([sx, sy, sx, sy], np.float32)
        if q.input_points is not None:
            kw["input_points"] = q.input_points * np.array([sx, sy], np.float32)
        queries.append(replace(q, **kw))
    return replace(dp, image=img, queries=queries)


class Compose:
    """Sequential pipeline of (dp, rng) -> dp transforms."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, dp: Datapoint, rng: np.random.RandomState) -> Datapoint:
        for t in self.transforms:
            dp = t(dp, rng)
        return dp


class RandomResize:
    """Resize to a randomly chosen size from ``sizes`` (square=True is the
    1008^2 production mode)."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 square: bool = False):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.square = square

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        size = self.sizes[rng.randint(len(self.sizes))]
        return resize_datapoint(dp, size, self.max_size, self.square)


class NormalizeToTensor:
    """float [0,1] -> (x-mean)/std, CHW; with ``device_normalize`` CHW uint8,
    normalized by the model on the device (mean = std = 0.5 only)."""

    def __init__(self, mean: float = 0.5, std: float = 0.5,
                 device_normalize: bool = False):
        if device_normalize and (mean != 0.5 or std != 0.5):
            raise ValueError("device_normalize requires mean=std=0.5")
        self.mean, self.std = mean, std
        self.device_normalize = device_normalize

    def __call__(self, dp: Datapoint, rng=None) -> Datapoint:
        if self.device_normalize:
            img = dp.image
            if img.dtype != np.uint8:
                img = np.clip(np.round(_as_float(img) * 255.0), 0, 255).astype(
                    np.uint8
                )
            return replace(dp, image=img.transpose(2, 0, 1))
        img = (_as_float(dp.image) - self.mean) / self.std
        return replace(dp, image=img.transpose(2, 0, 1))


def eval_transforms(img_size: int = 1008, device_normalize: bool = True) -> Compose:
    return Compose([
        RandomResize([img_size], square=True),
        NormalizeToTensor(device_normalize=device_normalize),
    ])
