"""COCO-format data pipeline with static-shape batches (port of
``sam3_lora_tpu/train/data.py``), emitting the port's ``Batch``/``Targets``
as CPU tensors.

Per image: decode, resize to the model's square input (uint8, normalized on
the device by the ViT), polygon/RLE masks decoded at the original size,
resized with the image and area-downsampled to ``mask_loss_resolution``,
boxes normalized to cxcywh, and the category-aware query text. Targets pad
to ``max_targets`` slots with validity masks.

The datapoint schema and the eval transform are the port's own
(``train/transforms.py``), as is the COCO segmentation decoder
(``ops/rle.py``). PIL is imported only by the functions that decode or
write images.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..models.geometry import GeoPrompt
from ..models.sam3_image import Batch, Targets
from ..models.tokenizer import get_default_tokenizer
from ..ops.rle import segmentation_to_mask
from . import transforms as T


@dataclass
class Sample:
    """One decoded query: image + padded targets + query text."""

    image: np.ndarray          # (3, R, R) uint8, or float32 already normalized
    text: str
    boxes: np.ndarray          # (T, 4) normalized cxcywh
    valid: np.ndarray          # (T,) bool
    masks: np.ndarray          # (T, m, m) bool
    mask_valid: np.ndarray     # (T,) bool
    is_exhaustive: bool
    coco_image_id: int = -1
    original_size: Tuple[int, int] = (0, 0)  # (h, w)


def downsample_mask(mask: np.ndarray, out: int) -> np.ndarray:
    """Area-average downsample, then threshold at 0.5."""
    h, w = mask.shape
    if h == out and w == out:
        return mask.astype(np.float32)
    fy, fx = h // out, w // out
    if fy * out == h and fx * out == w:
        m = mask[: fy * out, : fx * out].reshape(out, fy, out, fx).mean(axis=(1, 3))
    else:  # generic fallback via PIL bilinear
        from PIL import Image

        m = np.asarray(
            Image.fromarray((mask * 255).astype(np.uint8)).resize((out, out), Image.BILINEAR),
            dtype=np.float32,
        ) / 255.0
    return (m > 0.5).astype(np.float32)


def pad_targets(query: Optional["T.Query"], cfg: ModelConfig, r: int):
    """A query's objects (absolute xyxy boxes, full-size masks) -> padded
    (boxes cxcywh, valid, masks, mask_valid) of ``max_targets`` slots."""
    t_max, m_res = cfg.max_targets, cfg.mask_loss_resolution
    boxes = np.zeros((t_max, 4), np.float32)
    valid = np.zeros((t_max,), bool)
    masks = np.zeros((t_max, m_res, m_res), bool)
    mask_valid = np.zeros((t_max,), bool)
    if query is not None:
        for i in range(min(query.num_objects, t_max)):
            x0, y0, x1, y1 = query.boxes[i]
            boxes[i] = [(x0 + x1) / 2 / r, (y0 + y1) / 2 / r, (x1 - x0) / r, (y1 - y0) / r]
            valid[i] = True
            if query.masks is not None and query.masks[i].any():
                masks[i] = downsample_mask(query.masks[i].astype(np.float32), m_res) > 0.5
                mask_valid[i] = True
    return boxes, valid, masks, mask_valid


class COCOSegmentDataset:
    """Reads ``<data_dir>/<split>/_annotations.coco.json`` (Roboflow layout).
    ``transforms`` is an optional datapoint pipeline, a callable
    ``(Datapoint, RandomState) -> Datapoint`` ending at CHW (as the JAX
    package's ``train/transforms.py`` pipelines do); by default images are
    resized only."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        model_config: Optional[ModelConfig] = None,
        transforms=None,
        seed: int = 0,
        per_category_queries: bool = False,
        include_negatives: bool = False,
    ):
        self.cfg = model_config or ModelConfig()
        self.transforms = transforms
        self.seed = seed
        self.split_dir = Path(data_dir) / split
        ann_file = self.split_dir / "_annotations.coco.json"
        if not ann_file.exists():
            raise FileNotFoundError(f"COCO annotation file not found: {ann_file}")
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.images = {im["id"]: im for im in self.coco["images"]}
        self.image_ids = sorted(self.images)
        self.img_to_anns: Dict[int, List[dict]] = {}
        for ann in self.coco["annotations"]:
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)
        self.categories = {c["id"]: c["name"] for c in self.coco["categories"]}
        # one category-aware query per image, or one per (image, category)
        # with absent categories as empty-target negatives
        self._datapoints: List[Tuple[int, Optional[int]]] = []
        if per_category_queries:
            for img_id in self.image_ids:
                present = {a.get("category_id", 0) for a in self.img_to_anns.get(img_id, [])}
                for cat_id in sorted(self.categories):
                    if cat_id in present or include_negatives:
                        self._datapoints.append((img_id, cat_id))
        else:
            self._datapoints = [(i, None) for i in self.image_ids]

    def __len__(self) -> int:
        return len(self._datapoints)

    @staticmethod
    def _category_text(class_names: List[str]) -> str:
        if not class_names:
            return "object"
        return Counter(class_names).most_common(1)[0][0].lower()

    def load_datapoint(self, idx: int) -> "T.Datapoint":
        """Decode one image and its annotations at the original size."""
        from PIL import Image

        img_id, cat_id = self._datapoints[idx]
        info = self.images[img_id]
        pil = Image.open(self.split_dir / info["file_name"]).convert("RGB")
        orig_w, orig_h = pil.size
        img = np.asarray(pil, dtype=np.uint8)
        anns = self.img_to_anns.get(img_id, [])
        if cat_id is not None:
            anns = [a for a in anns if a.get("category_id", 0) == cat_id]
        boxes, masks, crowds, names = [], [], [], []
        for ann in anns:
            bbox = ann.get("bbox")
            if bbox is None:
                continue
            x, y, w, h = bbox
            boxes.append([x, y, x + w, y + h])
            names.append(self.categories.get(ann.get("category_id", 0), "object"))
            crowds.append(bool(ann.get("iscrowd", 0)))
            m = None
            if ann.get("segmentation"):
                try:
                    m = segmentation_to_mask(ann["segmentation"], orig_h, orig_w).astype(np.uint8)
                except (ValueError, TypeError, KeyError):  # malformed: no mask target
                    m = None
            masks.append(m if m is not None else np.zeros((orig_h, orig_w), np.uint8))
        query = T.Query(
            text=(self.categories[cat_id].lower() if cat_id is not None
                  else self._category_text(names)),
            boxes=np.array(boxes, np.float32).reshape(-1, 4),
            masks=np.stack(masks) if masks else np.zeros((0, orig_h, orig_w), np.uint8),
            is_crowd=np.array(crowds, bool),
            is_exhaustive=True,
        )
        return T.Datapoint(image=img, queries=[query], coco_image_id=img_id,
                           original_size=(orig_h, orig_w))

    def load(self, idx: int, epoch: int = 0) -> Sample:
        r = self.cfg.img_size
        dp = self.load_datapoint(idx)
        if self.transforms is not None:
            rng = np.random.RandomState((self.seed * 1000003 + epoch * 131071 + idx) % (2**31 - 1))
            dp = self.transforms(dp, rng)
        else:
            dp = T.eval_transforms(r)(dp, np.random.RandomState(0))
        img = dp.image
        if img.shape != (3, r, r):
            raise ValueError(f"transform pipeline must end at (3,{r},{r}), got {img.shape}")
        q = dp.queries[0] if dp.queries else None
        boxes, valid, masks, mask_valid = pad_targets(q, self.cfg, r)
        return Sample(
            image=np.ascontiguousarray(img if img.dtype == np.uint8 else img.astype(np.float32)),
            text=q.text if q is not None else "object",
            boxes=boxes, valid=valid, masks=masks, mask_valid=mask_valid,
            is_exhaustive=q.is_exhaustive if q is not None else True,
            coco_image_id=dp.coco_image_id,
            original_size=dp.original_size,
        )


def collate(samples: Sequence[Sample], tokenizer=None, cfg: Optional[ModelConfig] = None) -> Batch:
    """Static-shape batch of CPU tensors: images (B, 3, R, R), one text
    query per row, empty geometry prompts, padded targets."""
    cfg = cfg or ModelConfig()
    tok = tokenizer or get_default_tokenizer()
    b = len(samples)
    ids = tok([s.text for s in samples], context_length=cfg.text_context_length)
    t = torch.from_numpy
    return Batch(
        images=t(np.stack([s.image for s in samples])),
        token_ids=t(np.asarray(ids, np.int64)),
        img_ids=torch.arange(b),
        geo=GeoPrompt(
            boxes=torch.zeros((b, cfg.max_prompt_boxes, 4)),
            mask=torch.ones((b, cfg.max_prompt_boxes), dtype=torch.bool),
            labels=torch.ones((b, cfg.max_prompt_boxes), dtype=torch.long),
        ),
        targets=Targets(
            boxes=t(np.stack([s.boxes for s in samples])),
            valid=t(np.stack([s.valid for s in samples])),
            masks=t(np.stack([s.masks for s in samples])),
            mask_valid=t(np.stack([s.mask_valid for s in samples])),
            is_exhaustive=t(np.array([s.is_exhaustive for s in samples], bool)),
        ),
    )


class DataLoader:
    """Batches of a dataset in a seeded order per epoch, decoded by a thread
    pool a few batches ahead of the consumer. With ``host_shard``
    (``parallel.multihost.HostShard``) a rank takes its share of each
    epoch's order, cut after the seeded shuffle, so the ranks draw disjoint
    samples of one permutation."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 2, drop_last: bool = True, tokenizer=None,
                 prefetch: int = 2, host_shard=None):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.workers = max(1, num_workers)
        self.drop_last = drop_last
        self.tok = tokenizer or get_default_tokenizer()
        self.prefetch = prefetch
        self.host_shard = host_shard

    def __len__(self) -> int:
        n = len(self.ds)
        if self.host_shard is not None:
            n = len(self.host_shard.indices(n))
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def order(self, epoch: int) -> np.ndarray:
        """This rank's sample order of ``epoch``."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if self.host_shard is not None:
            order = order[self.host_shard.indices(len(order))]
        return order

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self.order(epoch)
        chunks = [order[i * self.bs:(i + 1) * self.bs] for i in range(len(self))]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for idxs in chunks:
                        samples = list(pool.map(lambda i: self.ds.load(i, epoch=epoch), idxs))
                        item = collate(samples, self.tok, self.ds.cfg)
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                q.put(None)
            except Exception as e:  # handed to the consumer, raised there
                q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)


def make_synthetic_coco(root: str, split: str = "train", num_images: int = 8,
                        img_size: int = 64, category: str = "crack", seed: int = 0,
                        extra_categories: Sequence[str] = ()) -> str:
    """Write a tiny COCO dataset of random rectangles with polygon masks (the
    same files as the JAX package's ``make_synthetic_coco`` from the same
    arguments)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    split_dir = Path(root) / split
    split_dir.mkdir(parents=True, exist_ok=True)
    cat_names = [category, *extra_categories]
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        arr = (rng.rand(img_size, img_size, 3) * 80).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            w = rng.randint(img_size // 8, img_size // 3)
            h = rng.randint(img_size // 8, img_size // 3)
            x = rng.randint(0, img_size - w)
            y = rng.randint(0, img_size - h)
            arr[y:y + h, x:x + w] = 220
            annotations.append({
                "id": ann_id, "image_id": i,
                "category_id": 1 + (ann_id - 1) % len(cat_names),
                "bbox": [float(x), float(y), float(w), float(h)],
                "area": float(w * h), "iscrowd": 0,
                "segmentation": [[float(x), float(y), float(x + w), float(y),
                                  float(x + w), float(y + h), float(x), float(y + h)]],
            })
            ann_id += 1
        fname = f"img_{i:04d}.jpg"
        Image.fromarray(arr).save(split_dir / fname, quality=90)
        images.append({"id": i, "file_name": fname, "width": img_size, "height": img_size})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": j + 1, "name": n} for j, n in enumerate(cat_names)]}
    with open(split_dir / "_annotations.coco.json", "w") as f:
        json.dump(coco, f)
    return str(root)
