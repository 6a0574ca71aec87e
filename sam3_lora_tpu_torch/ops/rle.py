"""COCO run-length encoding (host side): the port's own copy of
``sam3_lora_tpu/ops/rle.py``.

* ``rle_encode`` / ``rle_decode``: COCO compressed RLE (column-major runs,
  the first run counting zeros, the counts delta-coded in 6-bit chars
  offset by 48), through the native codec (``ops/rle_native.py``, which
  raises when it cannot be built); ``rle_encode_numpy`` /
  ``rle_decode_numpy`` are the plain versions it is held against, byte for
  byte the JAX package's ``rle_encode_numpy`` and pycocotools' rleToString /
  rleFrString;
* ``segmentation_to_mask``: a COCO ``segmentation`` field, polygons (PIL's
  polygon fill) or RLE (compressed string or uncompressed counts), to an
  (H, W) uint8 mask;
* ``rle_area``; ``rle_counts_device``, the run boundaries of a mask on its
  device (the string stays on the host).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from . import rle_native


def _mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths, first run counts zeros. mask: (H, W) {0,1}."""
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    if flat.size == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).astype(np.int64)
    if flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return counts


def _counts_to_string(counts: np.ndarray) -> str:
    """pycocotools rleToString: delta coding + 6-bit varint chars (+48)."""
    out = []
    cnts = counts.astype(np.int64)
    for i in range(len(cnts)):
        x = int(cnts[i])
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_encode_numpy(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict (the plain version)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _counts_to_string(_mask_to_counts(mask))}


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict (the native codec)."""
    return rle_native.rle_encode(mask)


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts)
    return int(np.sum(np.asarray(counts, dtype=np.int64)[1::2]))


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
    """COCO RLE dict (compressed string or uncompressed list) -> (H, W) uint8
    (the native codec)."""
    return rle_native.rle_decode(rle)


def rle_decode_numpy(rle: Dict) -> np.ndarray:
    """COCO RLE dict -> (H, W) uint8 (the plain version)."""
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


def rle_counts_device(mask: torch.Tensor):
    """Run boundaries of an (H, W) mask on its device: the column-major
    uint8 values and where a run starts (the first element always)."""
    flat = mask.to(torch.uint8).T.reshape(-1)  # column-major
    change = torch.cat([torch.ones((1,), dtype=torch.bool, device=flat.device),
                        flat[1:] != flat[:-1]])
    return flat, change
