"""COCO segmentation decoding (host side, numpy/PIL): the port's own copy of
the part of ``sam3_lora_tpu/ops/rle.py`` that ``train/data.py`` needs.

``segmentation_to_mask`` takes a COCO ``segmentation`` field, polygons or
RLE (compressed string or uncompressed counts), to an (H, W) uint8 mask.
Polygons rasterize with PIL's polygon fill; RLE decodes with the
pycocotools format (column-major runs, the first run counts zeros, the
compressed counts delta-coded in 6-bit chars offset by 48).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def _string_to_counts(s: Union[str, bytes]) -> np.ndarray:
    """pycocotools rleFrString."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[len(cnts) - 2]
        cnts.append(x)
    return np.asarray(cnts, dtype=np.int64)


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed string or uncompressed list) -> (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts)
    else:
        counts = np.asarray(counts, dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation(s) to a merged (H, W) uint8 mask."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        draw.polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Decode a COCO `segmentation` field of any flavour to (H, W) uint8."""
    if isinstance(seg, dict):
        return rle_decode(seg)
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    raise ValueError(f"Unknown segmentation format: {type(seg)}")
