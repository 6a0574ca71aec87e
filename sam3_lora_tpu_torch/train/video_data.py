"""Video-grounding training data (YTVIS-style annotations, host side): the
port's own copy of ``sam3_lora_tpu/train/video_data.py``, which imports no
JAX; its images and masks go through the port's ``train/data.py`` and
``ops/rle.py``.

Re-design of the reference's ``VideoGroundingDataset``
(``sam3/train/data/sam3_video_dataset.py:29-327``): per datapoint, sample
``num_stages`` frames with a random stride in [stride_min, stride_max],
optionally reverse the time axis, decode per-frame instance masks with
STABLE per-object track ids (the association losses key on them), and pad
everything to static shapes (one shape for every clip of a dataset).

Also supports the reference's image-tiling mode (synthesizing a "video" by
repeating a single image, ``is_tiling_single_image``) and ships a synthetic
moving-rectangles YTVIS generator for tests.

Annotation format (YTVIS-flavoured JSON):
    videos:      [{id, file_names: [...], height, width}]
    annotations: [{id, video_id, category_id,
                   segmentations: [RLE-or-None per frame],
                   bboxes: [xywh-or-None per frame]}]
    categories:  [{id, name}]
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..ops.rle import segmentation_to_mask
from .data import IMAGE_MEAN, IMAGE_STD, downsample_mask

__all__ = ["VideoSample", "VideoGroundingDataset", "make_synthetic_ytvis"]


@dataclass
class VideoSample:
    """One sampled clip: static (T, K) object slots with stable track ids."""

    frames: np.ndarray        # (T, 3, R, R) float32 normalized
    text: str
    boxes: np.ndarray         # (T, K, 4) normalized cxcywh
    valid: np.ndarray         # (T, K) bool — object visible in frame
    masks: np.ndarray         # (T, K, m, m) float32
    mask_valid: np.ndarray    # (T, K) bool
    track_ids: np.ndarray     # (K,) int32 stable ids, -1 = empty slot
    video_id: int = -1


class VideoGroundingDataset:
    def __init__(
        self,
        data_dir: str,
        ann_file: str = "annotations.json",
        model_config: Optional[ModelConfig] = None,
        num_stages: int = 4,
        stride_min: int = 1,
        stride_max: int = 5,
        random_reverse: bool = True,
        max_objects: Optional[int] = None,
        training: bool = True,
        tile_image_dataset=None,   # COCOSegmentDataset -> tiling mode
        seed: int = 0,
    ):
        assert num_stages >= 1 and 1 <= stride_min <= stride_max
        self.cfg = model_config or ModelConfig()
        self.dir = Path(data_dir)
        self.num_stages = num_stages
        self.stride_min = stride_min
        self.stride_max = stride_max
        self.random_reverse = random_reverse
        self.max_objects = max_objects or self.cfg.max_targets
        self.training = training
        self.tile_ds = tile_image_dataset
        self.seed = seed

        if tile_image_dataset is not None:
            self.videos = None
            self._len = len(tile_image_dataset)
            return
        with open(self.dir / ann_file) as f:
            data = json.load(f)
        self.videos = {v["id"]: v for v in data["videos"]}
        self.video_ids = sorted(self.videos)
        self.categories = {c["id"]: c["name"] for c in data.get("categories", [])}
        self.vid_to_anns: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            self.vid_to_anns.setdefault(ann["video_id"], []).append(ann)
        self._len = len(self.video_ids)

    def __len__(self) -> int:
        return self._len

    # ------------------------------------------------------------------ #
    def _sample_stage_ids(self, n_frames: int, rng) -> List[int]:
        """Random-stride window, clipped to the video (reference
        _sample_stage_ids); eval keeps the leading num_stages at stride 1."""
        t = self.num_stages
        if not self.training:
            return list(range(min(t, n_frames))) + [n_frames - 1] * max(
                0, t - n_frames
            )
        stride = rng.randint(self.stride_min, self.stride_max + 1)
        span = (t - 1) * stride
        while span >= n_frames and stride > 1:
            stride -= 1
            span = (t - 1) * stride
        start = rng.randint(0, max(1, n_frames - span))
        ids = [min(start + i * stride, n_frames - 1) for i in range(t)]
        if self.random_reverse and rng.rand() < 0.5:
            ids = ids[::-1]
        return ids

    def _decode_frame(self, path: Path, r: int) -> Tuple[np.ndarray, int, int]:
        from PIL import Image

        pil = Image.open(path).convert("RGB")
        ow, oh = pil.size
        arr = np.asarray(pil.resize((r, r), Image.BILINEAR), np.float32) / 255.0
        arr = ((arr - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)
        return arr, oh, ow

    def load(self, idx: int, epoch: int = 0) -> VideoSample:
        rng = np.random.RandomState(
            (self.seed * 1000003 + epoch * 131071 + idx) % (2**31 - 1)
        )
        if self.tile_ds is not None:
            return self._load_tiled(idx, epoch)

        cfg = self.cfg
        r, k, m = cfg.img_size, self.max_objects, cfg.mask_loss_resolution
        vid = self.videos[self.video_ids[idx]]
        anns = self.vid_to_anns.get(vid["id"], [])
        stage_ids = self._sample_stage_ids(len(vid["file_names"]), rng)
        t = self.num_stages

        frames = np.zeros((t, 3, r, r), np.float32)
        boxes = np.zeros((t, k, 4), np.float32)
        valid = np.zeros((t, k), bool)
        masks = np.zeros((t, k, m, m), np.float32)
        mask_valid = np.zeros((t, k), bool)
        track_ids = np.full((k,), -1, np.int32)
        names: List[str] = []

        slot_of: Dict[int, int] = {}
        for ann in anns:
            if len(slot_of) >= k:
                break
            slot_of[ann["id"]] = len(slot_of)
            track_ids[slot_of[ann["id"]]] = ann["id"]
            names.append(self.categories.get(ann.get("category_id", 0), "object"))

        oh = ow = None
        for ti, fi in enumerate(stage_ids):
            frames[ti], oh, ow = self._decode_frame(
                self.dir / vid["file_names"][fi], r
            )
            for ann in anns:
                s = slot_of.get(ann["id"])
                if s is None:
                    continue
                bb = (ann.get("bboxes") or [None] * (fi + 1))[fi]
                seg = (ann.get("segmentations") or [None] * (fi + 1))[fi]
                if bb is not None:
                    x, y, w, h = bb
                    sx, sy = r / ow, r / oh
                    x0, y0, x1, y1 = x * sx, y * sy, (x + w) * sx, (y + h) * sy
                    boxes[ti, s] = [
                        (x0 + x1) / 2 / r, (y0 + y1) / 2 / r,
                        (x1 - x0) / r, (y1 - y0) / r,
                    ]
                    valid[ti, s] = True
                if seg is not None:
                    try:
                        mm = segmentation_to_mask(seg, oh, ow)
                        masks[ti, s] = downsample_mask(mm.astype(np.float32), m)
                        mask_valid[ti, s] = True
                        if not valid[ti, s]:  # box from mask when absent
                            ys, xs = np.nonzero(mm)
                            if len(ys):
                                x0, y0 = xs.min() / ow, ys.min() / oh
                                x1, y1 = (xs.max() + 1) / ow, (ys.max() + 1) / oh
                                boxes[ti, s] = [
                                    (x0 + x1) / 2, (y0 + y1) / 2,
                                    x1 - x0, y1 - y0,
                                ]
                                valid[ti, s] = True
                    except Exception:
                        pass

        text = (
            Counter(names).most_common(1)[0][0].lower() if names else "object"
        )
        return VideoSample(
            frames=frames, text=text, boxes=boxes, valid=valid,
            masks=masks, mask_valid=mask_valid, track_ids=track_ids,
            video_id=vid["id"],
        )

    def _load_tiled(self, idx: int, epoch: int) -> VideoSample:
        """Image-tiling mode: one COCO image repeated num_stages times with
        consistent track ids (reference is_tiling_single_image)."""
        s = self.tile_ds.load(idx, epoch=epoch)
        t, k = self.num_stages, self.max_objects
        kk = min(k, s.boxes.shape[0])
        ids = np.full((k,), -1, np.int32)
        n = int(s.valid.sum())
        ids[:n] = np.arange(n)
        return VideoSample(
            frames=np.repeat(s.image[None], t, axis=0),
            text=s.text,
            boxes=np.repeat(s.boxes[None, :kk], t, axis=0),
            valid=np.repeat(s.valid[None, :kk], t, axis=0),
            masks=np.repeat(s.masks[None, :kk], t, axis=0),
            mask_valid=np.repeat(s.mask_valid[None, :kk], t, axis=0),
            track_ids=ids,
            video_id=idx,
        )


# ---------------------------------------------------------------------------
# Synthetic YTVIS (moving rectangles) for tests
# ---------------------------------------------------------------------------


def make_synthetic_ytvis(
    root: str,
    num_videos: int = 2,
    num_frames: int = 6,
    img_size: int = 64,
    category: str = "crack",
    seed: int = 0,
) -> str:
    from PIL import Image

    from ..ops.rle import rle_encode

    rng = np.random.RandomState(seed)
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    videos, annotations = [], []
    ann_id = 1
    for v in range(num_videos):
        vdir = rootp / f"video_{v:03d}"
        vdir.mkdir(exist_ok=True)
        n_obj = rng.randint(1, 3)
        objs = []
        for _ in range(n_obj):
            w = rng.randint(img_size // 8, img_size // 4)
            h = rng.randint(img_size // 8, img_size // 4)
            x = rng.randint(0, img_size // 2)
            y = rng.randint(0, img_size // 2)
            vx, vy = rng.randint(-3, 4), rng.randint(-3, 4)
            objs.append([x, y, w, h, vx, vy])
        file_names, segs, bbs = [], [[] for _ in objs], [[] for _ in objs]
        for f in range(num_frames):
            arr = (rng.rand(img_size, img_size, 3) * 60).astype(np.uint8)
            for oi, (x, y, w, h, vx, vy) in enumerate(objs):
                xx = int(np.clip(x + vx * f, 0, img_size - w))
                yy = int(np.clip(y + vy * f, 0, img_size - h))
                arr[yy : yy + h, xx : xx + w] = 220
                mask = np.zeros((img_size, img_size), np.uint8)
                mask[yy : yy + h, xx : xx + w] = 1
                segs[oi].append(rle_encode(mask))
                bbs[oi].append([float(xx), float(yy), float(w), float(h)])
            fname = f"video_{v:03d}/{f:05d}.jpg"
            Image.fromarray(arr).save(rootp / fname, quality=92)
            file_names.append(fname)
        videos.append(
            {"id": v, "file_names": file_names,
             "height": img_size, "width": img_size}
        )
        for oi in range(n_obj):
            annotations.append(
                {"id": ann_id, "video_id": v, "category_id": 1,
                 "segmentations": segs[oi], "bboxes": bbs[oi]}
            )
            ann_id += 1
    with open(rootp / "annotations.json", "w") as f:
        json.dump(
            {"videos": videos, "annotations": annotations,
             "categories": [{"id": 1, "name": category}]},
            f,
        )
    return str(root)
