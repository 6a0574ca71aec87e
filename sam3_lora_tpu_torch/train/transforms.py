"""Datapoint-level data augmentation (host side, numpy): the port's own copy
of ``sam3_lora_tpu/train/transforms.py``, the whole pipeline, statement for
statement (``tests/test_torch_transforms.py``). ``COCOSegmentDataset`` takes
any of its pipelines as ``transforms=`` (``train_transforms`` for training
with augmentation); ``train/data.py`` and ``train/video_data.py`` use its
schema and ``eval_transforms``.

Every transform is a pure function over a numpy :class:`Datapoint` (image +
per-query objects at native resolution), applied in CPU loader workers
*before* static-shape padding, so the device-side train step sees one
shape regardless of augmentation.

Geometry convention: boxes are absolute xyxy pixels inside transforms
(matching the reference, which keeps xyxy until the final normalize step,
``basic_for_api.py:868-921``); the collator converts to normalized cxcywh.

Covered (reference file:lines):
* resize / square resize with scale list   basic_for_api.py:166-239,600-646
* pad-to-size                              basic_for_api.py:240-328,670-714
* horizontal flip                          basic_for_api.py:116-144,583-599
* random size crop / center crop           basic_for_api.py:26-115,329-582
* color jitter + grayscale                 basic_for_api.py:941-1013
* 2x2 mosaic                               basic_for_api.py:715-832
* to-tensor + normalize (mean/std 0.5)     basic_for_api.py:868-921
* random select / compose / identity       basic_for_api.py:846-940
* box noising for interactive prompts      point_sampling.py:136-155,309-...
* point sampling from masks                point_sampling.py:34-113
* query filters (crowds / empty / too-many-out / text->visual)
                                           filter_query_transforms.py:14-607
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Query",
    "Datapoint",
    "Compose",
    "Identity",
    "RandomSelect",
    "RandomResize",
    "PadToSize",
    "RandomHorizontalFlip",
    "RandomSizeCrop",
    "CenterCrop",
    "ColorJitter",
    "RandomGrayscale",
    "RandomMosaic",
    "NormalizeToTensor",
    "RandomizeInputBoxes",
    "SamplePointsFromMasks",
    "FilterCrowds",
    "FilterEmptyTargets",
    "FilterQueriesWithTooManyOut",
    "KeepMaxNumQueries",
    "TextQueryToVisual",
    "noise_box",
]


# ---------------------------------------------------------------------------
# Datapoint schema (host-side analogue of sam3_image_dataset.py:30-132)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Core geometric ops
# ---------------------------------------------------------------------------


def resize_datapoint(
    dp: Datapoint,
    size: int,
    max_size: Optional[int] = None,
    square: bool = False,
) -> Datapoint:
    """Aspect-preserving shorter-side resize (or square). Mirrors
    ``resize``/``get_size_with_aspect_ratio`` basic_for_api.py:145-239."""
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


def crop_datapoint(dp: Datapoint, top: int, left: int, ch: int, cw: int) -> Datapoint:
    """Crop image + clip boxes/masks; drops objects that fall fully outside
    (reference ``crop`` basic_for_api.py:26-115)."""
    img = dp.image[top : top + ch, left : left + cw]
    queries = []
    for q in dp.queries:
        boxes = q.boxes - np.array([left, top, left, top], np.float32)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        masks = q.masks
        if masks is not None:
            masks = masks[:, top : top + ch, left : left + cw]
            # mask-bearing objects survive only if pixels remain
            keep = keep & (masks.reshape(masks.shape[0], -1).any(axis=1))
            masks = masks[keep]
        q2 = replace(
            q,
            boxes=boxes[keep],
            masks=masks,
            is_crowd=None if q.is_crowd is None else q.is_crowd[keep],
            # a crop can remove objects, so exhaustiveness survives but the
            # query may now be empty; geometric inputs are clipped likewise
            is_exhaustive=q.is_exhaustive,
        )
        if q.input_boxes is not None:
            ib = q.input_boxes - np.array([left, top, left, top], np.float32)
            ib[:, 0::2] = np.clip(ib[:, 0::2], 0, cw)
            ib[:, 1::2] = np.clip(ib[:, 1::2], 0, ch)
            q2 = replace(q2, input_boxes=ib)
        if q.input_points is not None:
            pts = q.input_points - np.array([left, top], np.float32)
            q2 = replace(q2, input_points=pts)
        queries.append(q2)
    return replace(dp, image=img, queries=queries)


def hflip_datapoint(dp: Datapoint) -> Datapoint:
    """Horizontal flip (basic_for_api.py:116-144)."""
    h, w = dp.size
    img = dp.image[:, ::-1].copy()
    queries = []
    for q in dp.queries:
        boxes = q.boxes.copy()
        boxes[:, [0, 2]] = w - q.boxes[:, [2, 0]]
        kw = dict(boxes=boxes)
        if q.masks is not None:
            kw["masks"] = q.masks[:, :, ::-1].copy()
        if q.input_boxes is not None:
            ib = q.input_boxes.copy()
            ib[:, [0, 2]] = w - q.input_boxes[:, [2, 0]]
            kw["input_boxes"] = ib
        if q.input_points is not None:
            pts = q.input_points.copy()
            pts[:, 0] = w - pts[:, 0]
            kw["input_points"] = pts
        queries.append(replace(q, **kw))
    return replace(dp, image=img, queries=queries)


def pad_datapoint(dp: Datapoint, out_h: int, out_w: int) -> Datapoint:
    """Bottom-right zero pad to (out_h, out_w) (basic_for_api.py:240-328)."""
    h, w = dp.size
    if h == out_h and w == out_w:
        return dp
    pad_h, pad_w = out_h - h, out_w - w
    if pad_h < 0 or pad_w < 0:
        raise ValueError(f"pad target {(out_h, out_w)} smaller than {(h, w)}")
    img = np.pad(dp.image, ((0, pad_h), (0, pad_w), (0, 0)))
    queries = [
        replace(
            q,
            masks=None
            if q.masks is None
            else np.pad(q.masks, ((0, 0), (0, pad_h), (0, pad_w))),
        )
        for q in dp.queries
    ]
    return replace(dp, image=img, queries=queries)


# ---------------------------------------------------------------------------
# Random transforms (each is a callable (dp, rng) -> dp)
# ---------------------------------------------------------------------------


class Compose:
    """Sequential pipeline (ComposeAPI basic_for_api.py:923-940)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, dp: Datapoint, rng: np.random.RandomState) -> Datapoint:
        for t in self.transforms:
            dp = t(dp, rng)
        return dp


class Identity:
    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        return dp


class RandomSelect:
    """Pick transform a with prob p else b (basic_for_api.py:851-867)."""

    def __init__(self, a, b, p: float = 0.5):
        self.a, self.b, self.p = a, b, p

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        return self.a(dp, rng) if rng.rand() < self.p else self.b(dp, rng)


class RandomResize:
    """Resize to a randomly chosen size from ``sizes`` (RandomResizeAPI
    basic_for_api.py:600-628; square=True is the 1008^2 production mode)."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 square: bool = False):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.square = square

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        size = self.sizes[rng.randint(len(self.sizes))]
        return resize_datapoint(dp, size, self.max_size, self.square)


class PadToSize:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        return pad_datapoint(dp, self.size, self.size)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        return hflip_datapoint(dp) if rng.rand() < self.p else dp


class RandomSizeCrop:
    """Random crop with size in [min_size, max_size] per side
    (RandomSizeCropAPI basic_for_api.py:329-540). ``respect_boxes`` retries
    to keep at least one object."""

    def __init__(self, min_size: int, max_size: int, respect_boxes: bool = True,
                 retries: int = 10):
        self.min_size = min_size
        self.max_size = max_size
        self.respect_boxes = respect_boxes
        self.retries = retries

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        h, w = dp.size
        n_before = sum(q.num_objects for q in dp.queries)
        for _ in range(self.retries):
            cw = rng.randint(min(w, self.min_size), min(w, self.max_size) + 1)
            ch = rng.randint(min(h, self.min_size), min(h, self.max_size) + 1)
            top = rng.randint(0, h - ch + 1)
            left = rng.randint(0, w - cw + 1)
            out = crop_datapoint(dp, top, left, ch, cw)
            if not self.respect_boxes or n_before == 0:
                return out
            if sum(q.num_objects for q in out.queries) > 0:
                return out
        return dp


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        h, w = dp.size
        ch, cw = min(self.size, h), min(self.size, w)
        return crop_datapoint(dp, (h - ch) // 2, (w - cw) // 2, ch, cw)


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter on the image only
    (basic_for_api.py:959-1013). Factors sampled in [max(0,1-x), 1+x]."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        img = _as_float(dp.image)
        if self.brightness:
            img = img * rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        if self.contrast:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            mean = img.mean(axis=(0, 1), keepdims=True)
            img = (img - mean) * f + mean
        if self.saturation:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            img = (img - gray[..., None]) * f + gray[..., None]
        if self.hue:
            # cheap hue rotation: cyclic channel mix by angle
            theta = rng.uniform(-self.hue, self.hue) * 2 * np.pi
            c, s = np.cos(theta), np.sin(theta)
            one3 = 1.0 / 3.0
            sq3 = np.sqrt(1.0 / 3.0)
            m = np.full((3, 3), one3 * (1.0 - c), np.float32)
            m += np.eye(3, dtype=np.float32) * c
            m += s * np.array(
                [[0, -sq3, sq3], [sq3, 0, -sq3], [-sq3, sq3, 0]], np.float32
            )
            img = img @ m.T
        img = np.clip(img, 0, 1)
        if dp.image.dtype == np.uint8:
            img = (img * 255).astype(np.uint8)
        return replace(dp, image=img)


class RandomGrayscale:
    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        if rng.rand() >= self.p:
            return dp
        img = _as_float(dp.image)
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
        img = np.repeat(gray[..., None], 3, axis=-1)
        if dp.image.dtype == np.uint8:
            img = (img * 255).astype(np.uint8)
        return replace(dp, image=img)


class RandomMosaic:
    """2x2 mosaic of a datapoint with 3 partners (RandomMosaicVideoAPI
    basic_for_api.py:715-832): each cell resized to (size/2)^2, queries of
    the SAME text merged (targets concatenated), others kept non-exhaustive.

    Partners are supplied by a ``sampler(rng) -> Datapoint`` callable so the
    dataset controls IO.
    """

    def __init__(self, sampler, size: int, p: float = 0.5):
        self.sampler = sampler
        self.size = size
        self.p = p

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        if rng.rand() >= self.p:
            return dp
        half = self.size // 2
        cells = [resize_datapoint(dp, half, square=True)]
        for _ in range(3):
            cells.append(resize_datapoint(self.sampler(rng), half, square=True))
        canvas = np.zeros((self.size, self.size, 3), _as_float(cells[0].image).dtype)
        offsets = [(0, 0), (0, half), (half, 0), (half, half)]
        merged: dict = {}
        for (oy, ox), cell in zip(offsets, cells):
            canvas[oy : oy + half, ox : ox + half] = _as_float(cell.image)
            for q in cell.queries:
                boxes = q.boxes + np.array([ox, oy, ox, oy], np.float32)
                masks = q.masks
                if masks is not None:
                    full = np.zeros(
                        (masks.shape[0], self.size, self.size), masks.dtype
                    )
                    full[:, oy : oy + half, ox : ox + half] = masks
                    masks = full
                key = q.text
                if key in merged:
                    m = merged[key]
                    merged[key] = replace(
                        m,
                        boxes=np.concatenate([m.boxes, boxes]),
                        masks=None
                        if (m.masks is None or masks is None)
                        else np.concatenate([m.masks, masks]),
                        is_crowd=None,
                        is_exhaustive=m.is_exhaustive and q.is_exhaustive,
                    )
                else:
                    merged[key] = replace(
                        q, boxes=boxes, masks=masks, is_crowd=None
                    )
        return replace(dp, image=canvas, queries=list(merged.values()))


class NormalizeToTensor:
    """float [0,1] -> (x-mean)/std, CHW (ToTensorAPI+NormalizeAPI
    basic_for_api.py:868-921; production mean=std=0.5).

    ``device_normalize=True`` instead emits CHW **uint8** and defers the
    normalization to the model (ViT casts ``u*(2/255)-1`` on device,
    models/vit.py). Numerically identical for the production mean=std=0.5
    — every float image in the pipeline sits on the k/255 grid (photometric
    ops quantize back to uint8, resize round-trips through PIL uint8) — and
    it quarters the host->device image bytes (24 MB vs 97 MB per bs8 batch),
    which on a host-bandwidth-starved input pipeline is the difference
    between hiding and not hiding the transfer (SURVEY hard-part #4)."""

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


# ---------------------------------------------------------------------------
# Interactive-prompt noising / point sampling (point_sampling.py)
# ---------------------------------------------------------------------------


def noise_box(
    box: np.ndarray,
    im_size: Tuple[int, int],
    std: float = 0.1,
    max_shift: float = 20.0,
    min_box_area: float = 4.0,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Jitter an xyxy box by gaussian noise scaled to side length, clamped to
    ``max_shift`` px and the image bounds (point_sampling.py:136-155)."""
    rng = rng or np.random.RandomState()
    h, w = im_size
    bw, bh = box[2] - box[0], box[3] - box[1]
    scale = np.array([bw, bh, bw, bh], np.float32)
    shift = np.clip(rng.randn(4).astype(np.float32) * std * scale,
                    -max_shift, max_shift)
    out = box + shift
    out[0::2] = np.clip(out[0::2], 0, w)
    out[1::2] = np.clip(out[1::2], 0, h)
    if (out[2] - out[0]) * (out[3] - out[1]) < min_box_area:
        return box.astype(np.float32)
    return out.astype(np.float32)


class RandomizeInputBoxes:
    """Noise every query's input boxes (RandomizeInputBbox
    point_sampling.py:309-...)."""

    def __init__(self, std: float = 0.1, max_shift: float = 20.0):
        self.std, self.max_shift = std, max_shift

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        queries = []
        for q in dp.queries:
            if q.input_boxes is None or q.input_boxes.shape[0] == 0:
                queries.append(q)
                continue
            ib = np.stack(
                [
                    noise_box(b, dp.size, self.std, self.max_shift, rng=rng)
                    for b in q.input_boxes
                ]
            )
            queries.append(replace(q, input_boxes=ib))
        return replace(dp, queries=queries)


def sample_points_from_mask(
    mask: np.ndarray,
    n_points: int,
    mode: str = "uniform",
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """(n,2) xy points from a binary mask: 'uniform' over foreground or
    'center' biased to the interior via the distance transform
    (point_sampling.py:47-94; center mode uses EDT like the reference)."""
    rng = rng or np.random.RandomState()
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((n_points, 2), np.float32)
    if mode == "uniform":
        idx = rng.randint(0, len(ys), size=n_points)
        return np.stack([xs[idx], ys[idx]], axis=1).astype(np.float32)
    if mode == "center":
        from scipy import ndimage

        dist = ndimage.distance_transform_edt(mask.astype(bool))
        flat = dist.ravel()
        top = np.argsort(flat)[-max(n_points * 4, 8):]
        idx = rng.choice(top, size=n_points)
        yy, xx = np.unravel_index(idx, mask.shape)
        return np.stack([xx, yy], axis=1).astype(np.float32)
    raise ValueError(f"unknown mode {mode}")


class SamplePointsFromMasks:
    """Populate input_points for queries that have masks but no geometric
    inputs (RandomGeometricInputsAPI point_sampling.py:156-308)."""

    def __init__(self, n_points: int = 1, mode: str = "uniform"):
        self.n_points, self.mode = n_points, mode

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        queries = []
        for q in dp.queries:
            if q.masks is None or q.masks.shape[0] == 0 or q.input_points is not None:
                queries.append(q)
                continue
            pts = np.concatenate(
                [
                    sample_points_from_mask(m, self.n_points, self.mode, rng)
                    for m in q.masks
                ]
            )
            queries.append(
                replace(
                    q,
                    input_points=pts,
                    input_point_labels=np.ones((pts.shape[0],), np.int32),
                )
            )
        return replace(dp, queries=queries)


# ---------------------------------------------------------------------------
# Query filters (filter_query_transforms.py)
# ---------------------------------------------------------------------------


class FilterCrowds:
    """Drop crowd objects from each query (filter_query_transforms.py:518-531)."""

    def __call__(self, dp: Datapoint, rng=None) -> Datapoint:
        queries = []
        for q in dp.queries:
            if q.is_crowd is None or not q.is_crowd.any():
                queries.append(q)
                continue
            keep = ~q.is_crowd
            queries.append(
                replace(
                    q,
                    boxes=q.boxes[keep],
                    masks=None if q.masks is None else q.masks[keep],
                    is_crowd=q.is_crowd[keep],
                )
            )
        return replace(dp, queries=queries)


class FilterEmptyTargets:
    """Drop queries with no objects unless they are exhaustive negatives
    (filter_query_transforms.py:269-283; keep_negatives mirrors the
    reference's allowance of explicit negative queries)."""

    def __init__(self, keep_negatives: bool = True):
        self.keep_negatives = keep_negatives

    def __call__(self, dp: Datapoint, rng=None) -> Datapoint:
        queries = [
            q
            for q in dp.queries
            if q.num_objects > 0 or (self.keep_negatives and q.is_exhaustive)
        ]
        return replace(dp, queries=queries)


class FilterQueriesWithTooManyOut:
    """Drop queries whose object count exceeds the query budget
    (filter_query_transforms.py:249-268)."""

    def __init__(self, max_objects: int):
        self.max_objects = max_objects

    def __call__(self, dp: Datapoint, rng=None) -> Datapoint:
        return replace(
            dp,
            queries=[q for q in dp.queries if q.num_objects <= self.max_objects],
        )


class KeepMaxNumQueries:
    """Randomly subsample to at most N queries
    (filter_query_transforms.py:53-103)."""

    def __init__(self, max_queries: int):
        self.max_queries = max_queries

    def __call__(self, dp: Datapoint, rng=None) -> Datapoint:
        if len(dp.queries) <= self.max_queries:
            return dp
        rng = rng or np.random.RandomState()
        idx = rng.choice(len(dp.queries), size=self.max_queries, replace=False)
        return replace(dp, queries=[dp.queries[i] for i in sorted(idx)])


class TextQueryToVisual:
    """With prob p, convert a text query to a visual-prompt query: one
    target box becomes the input box, text is cleared
    (filter_query_transforms.py:532-569)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, dp: Datapoint, rng) -> Datapoint:
        queries = []
        for q in dp.queries:
            if q.num_objects == 0 or q.input_boxes is not None or rng.rand() >= self.p:
                queries.append(q)
                continue
            i = rng.randint(q.num_objects)
            queries.append(
                replace(q, text="", input_boxes=q.boxes[i : i + 1].copy())
            )
        return replace(dp, queries=queries)


# ---------------------------------------------------------------------------
# Production pipelines (mirroring configs/ and the native trainer)
# ---------------------------------------------------------------------------


def train_transforms(
    img_size: int = 1008,
    hflip: bool = True,
    color_jitter: bool = False,
    scale_jitter: Optional[Sequence[float]] = None,
    device_normalize: bool = True,
) -> Compose:
    """The native LoRA trainer resize-only path, optionally widened with the
    official train augmentations (lora_base.yaml / basic_for_api usage)."""
    ts: List = []
    if hflip:
        ts.append(RandomHorizontalFlip(0.5))
    if color_jitter:
        ts.append(ColorJitter())
    if scale_jitter:
        sizes = [int(img_size * s) for s in scale_jitter]
        ts.append(RandomResize(sizes, square=True))
        ts.append(RandomSizeCrop(min(sizes + [img_size]), img_size))
    ts.append(RandomResize([img_size], square=True))
    ts.append(NormalizeToTensor(device_normalize=device_normalize))
    return Compose(ts)


def eval_transforms(img_size: int = 1008, device_normalize: bool = True) -> Compose:
    return Compose([
        RandomResize([img_size], square=True),
        NormalizeToTensor(device_normalize=device_normalize),
    ])
