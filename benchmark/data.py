"""Inputs made from the seed: images, a COCO-format training split, and the
streams of requests and sessions that the traffic files describe.

Every seed gets the same multiset of work in another order: the image sizes
come in equal shares, the instance counts cycle through their range, and
the prompt counts of requests are spread over each size in the traffic's
shares.
An image is a textured gray surface with dark instances of two shapes:
thin, branching crack-like strokes and rounded blobs, each a COCO polygon.
PIL draws the polygons, writes the JPEGs and nothing else.
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .weights import sub_seed


def _rng(seed: int, tag: str) -> np.random.RandomState:
    return np.random.RandomState(sub_seed(seed, tag, bits=31))


def _crack(rng, w: int, h: int) -> List[float]:
    """A thin stroke: a random walk of 6-14 steps, widened to 3-8 px."""
    n = rng.randint(6, 15)
    x, y = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
    ang = rng.uniform(0, 2 * math.pi)
    step = min(w, h) * rng.uniform(0.02, 0.05)
    pts = [(x, y)]
    for _ in range(n):
        ang += rng.uniform(-0.6, 0.6)
        x = float(np.clip(x + step * math.cos(ang), 1, w - 2))
        y = float(np.clip(y + step * math.sin(ang), 1, h - 2))
        pts.append((x, y))
    half = rng.uniform(1.5, 4.0)
    left, right = [], []
    for i, (px, py) in enumerate(pts):
        a, b = (pts[i], pts[i + 1]) if i + 1 < len(pts) else (pts[i - 1], pts[i])
        dx, dy = b[0] - a[0], b[1] - a[1]
        norm = math.hypot(dx, dy) or 1.0
        nx, ny = -dy / norm * half, dx / norm * half
        left.append((px + nx, py + ny))
        right.append((px - nx, py - ny))
    poly = left + right[::-1]
    return [float(np.clip(v, 0, (w - 1) if k % 2 == 0 else (h - 1)))
            for p in poly for k, v in enumerate(p)]


def _blob(rng, w: int, h: int) -> List[float]:
    """A rounded blob: 16 vertices at radii 0.7-1.3 of a mean radius."""
    r = min(w, h) * rng.uniform(0.04, 0.12)
    cx, cy = rng.uniform(r, w - r), rng.uniform(r, h - r)
    out = []
    for i in range(16):
        a = 2 * math.pi * i / 16
        rr = r * rng.uniform(0.7, 1.3)
        out += [float(np.clip(cx + rr * math.cos(a), 0, w - 1)),
                float(np.clip(cy + rr * math.sin(a), 0, h - 1))]
    return out


def draw_image(seed: int, index: int, size: Tuple[int, int], n_inst: int,
               categories: Sequence[str]):
    """-> (H, W, 3) uint8 image and its instances [(category index, polygon)]."""
    from PIL import Image, ImageDraw

    w, h = size
    rng = _rng(seed, f"image:{index}")
    base = rng.randint(90, 170)
    coarse = rng.randint(-25, 26, size=(h // 16 + 1, w // 16 + 1, 1))
    img = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    img = np.clip(base + img + rng.randint(-12, 13, size=(h, w, 3)), 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    inst = []
    for j in range(n_inst):
        cat = (index + j) % len(categories)
        poly = _crack(rng, w, h) if cat == 0 else _blob(rng, w, h)
        shade = int(rng.randint(10, 60))
        draw.polygon([(poly[k], poly[k + 1]) for k in range(0, len(poly), 2)],
                     fill=(shade, shade, shade))
        inst.append((cat, poly))
    return np.asarray(pil), inst


def _plan(seed: int, n: int, sizes: Sequence[Sequence[int]], inst_range: Sequence[int]):
    """(size, instance count) of each of ``n`` images: equal shares of the
    sizes, the counts cycling over their range, in a seeded order."""
    lo, hi = inst_range
    plan = [(tuple(sizes[i % len(sizes)]), lo + i % (hi - lo + 1)) for i in range(n)]
    order = _rng(seed, "plan").permutation(n)
    return [plan[i] for i in order]


def write_coco(root: str, seed: int, traffic: Dict) -> str:
    """Write ``<root>/train``: ``traffic["images"]`` JPEGs and
    ``_annotations.coco.json`` with polygon instances. Returns ``root``."""
    from PIL import Image

    split = Path(root) / "train"
    split.mkdir(parents=True, exist_ok=True)
    cats = traffic["categories"]
    plan = _plan(seed, traffic["images"], traffic["sizes"], traffic["instances"])

    def one(i):
        size, n_inst = plan[i]
        img, inst = draw_image(seed, i, size, n_inst, cats)
        name = f"img_{i:04d}.jpg"
        Image.fromarray(img).save(split / name, quality=90)
        return name, img.shape[:2], inst

    with ThreadPoolExecutor(max_workers=4) as pool:
        made = list(pool.map(one, range(len(plan))))
    images, anns = [], []
    for i, (name, (h, w), inst) in enumerate(made):
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        for cat, poly in inst:
            xs, ys = poly[0::2], poly[1::2]
            x0, y0 = min(xs), min(ys)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat + 1,
                         "bbox": [x0, y0, max(xs) - x0, max(ys) - y0],
                         "area": (max(xs) - x0) * (max(ys) - y0), "iscrowd": 0,
                         "segmentation": [poly]})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": j + 1, "name": c} for j, c in enumerate(cats)]}
    with open(split / "_annotations.coco.json", "w") as f:
        json.dump(coco, f)
    return root


def image_pool(seed: int, traffic: Dict) -> List[np.ndarray]:
    """``traffic["pool"]`` decoded images, held on the host."""
    plan = _plan(seed, traffic["pool"], traffic["sizes"], traffic["instances"])
    with ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(lambda i: draw_image(seed, i, *plan[i], traffic["categories"])[0],
                             range(len(plan))))


def requests(seed: int, traffic: Dict) -> List[Tuple[int, List[str]]]:
    """The cycle of requests (pool index, prompts) that the window repeats:
    each pool image once, in a seeded order, with phrases drawn from
    ``phrases``. The prompt counts are spread over each image size alike,
    in the traffic's shares (``prompts_per_request``: {count: share}, laid
    out over ``block`` requests), so that every seed sends the same set of
    (size, prompt count) pairs."""
    rng = _rng(seed, "requests")
    shares = {int(k): v for k, v in traffic["prompts_per_request"].items()}
    block = traffic.get("block", 10)
    pattern = [c for c, s in sorted(shares.items()) for _ in range(round(s * block))]
    pool_n, phrases = traffic["pool"], traffic["phrases"]
    plan = _plan(seed, pool_n, traffic["sizes"], traffic["instances"])
    count = {}
    for size in sorted({sz for sz, _ in plan}):
        group = [i for i, (sz, _) in enumerate(plan) if sz == size]
        counts = [pattern[j * len(pattern) // len(group)] for j in range(len(group))]
        for i, c in zip(group, rng.permutation(counts)):
            count[i] = int(c)
    return [(int(i), [phrases[j] for j in rng.choice(len(phrases), count[int(i)], replace=False)])
            for i in rng.permutation(pool_n)]


def sessions(seed: int, traffic: Dict, n: int) -> List[Tuple[int, List[str]]]:
    """``n`` sessions (pool index, ``prompts_per_session`` phrases)."""
    rng = _rng(seed, "sessions")
    k, pool_n, phrases = traffic["prompts_per_session"], traffic["pool"], traffic["phrases"]
    out, cycle = [], []
    while len(out) < n:
        if not cycle:
            cycle = list(rng.permutation(pool_n))
        out.append((int(cycle.pop()), [phrases[j] for j in rng.choice(len(phrases), k,
                                                                     replace=False)]))
    return out


def check_sample(seed: int, items: List, k: int, first: int, key=lambda j: j) -> List[int]:
    """``k`` of the first ``first`` items, drawn from the seed, with the item
    of the most prompts among them (``items[j][1]`` are its prompts or
    answers); returned as ``key(j)``, in order."""
    rng = _rng(seed, "check")
    first = min(first, len(items))
    if first == 0:
        return []
    pick = set(int(i) for i in rng.choice(first, min(k, first), replace=False))
    longest = max(range(first), key=lambda i: (len(items[i][1]), -i))
    if longest not in pick:
        pick.discard(max(pick))
        pick.add(longest)
    return sorted(key(j) for j in pick)
