"""Streaming prediction dumper + offline re-evaluation.

Re-design of the reference's ``sam3/eval/coco_writer.py:46-352``
(PredictionDumper) and ``coco_eval_offline.py``: during validation each
host streams its top-k predictions per image to a sharded JSONL file
(bounded memory via a per-image heap), shards are merged at the end, and
any number of pred-file evaluators (COCO mAP, cgF1) re-run offline from
the merged file without touching the model.

Masks are stored as COCO RLE strings (the port's ``ops/rle.py`` codec), boxes as xyxy in
original-image coordinates — the same record schema the validate CLI
consumes, so dumped files are interchangeable with live eval.

The PyTorch port's copy of ``sam3_lora_tpu/eval/writer.py`` (it imports no
JAX); ``tests/test_torch_eval.py`` holds the two equal.
"""

from __future__ import annotations

import heapq
import json
import os
from glob import glob
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from ..ops.rle import rle_encode

__all__ = ["PredictionDumper", "load_predictions", "evaluate_pred_file"]


def _to_record(image_id, score, box=None, mask=None, category_id=1) -> Dict:
    rec = {
        "image_id": int(image_id),
        "score": float(score),
        "category_id": int(category_id),
    }
    if box is not None:
        rec["bbox_xyxy"] = [float(v) for v in np.asarray(box).tolist()]
    if mask is not None:
        rle = rle_encode(np.asarray(mask).astype(np.uint8))
        if isinstance(rle["counts"], bytes):
            rle = dict(rle, counts=rle["counts"].decode("ascii"))
        rec["segmentation"] = rle
    return rec


class PredictionDumper:
    """Bounded-memory streaming writer (reference coco_writer.py:46-352).

    ``add(image_id, scores, boxes, masks)`` keeps only the ``top_k`` highest
    -scoring predictions per image (min-heap, reference's heap-based policy),
    ``flush()`` appends completed images to ``<out_dir>/preds_shard<i>.jsonl``,
    ``finalize()`` merges all shards into ``predictions.jsonl`` and returns
    its path. Shard index is the host/process id so multi-host validation
    writes disjoint files and the merge is the reference's filesystem-gather
    (distributed.py:57-113) analogue.
    """

    def __init__(self, out_dir: str, top_k: int = 100, shard: int = 0):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.top_k = top_k
        self.shard_path = os.path.join(out_dir, f"preds_shard{shard}.jsonl")
        # fresh shard per run
        open(self.shard_path, "w").close()
        self._heaps: Dict[int, List] = {}
        self._n = 0

    def add(
        self,
        image_id: int,
        scores: Iterable[float],
        boxes: Optional[np.ndarray] = None,
        masks: Optional[np.ndarray] = None,
        category_ids: Optional[Iterable[int]] = None,
    ):
        heap = self._heaps.setdefault(int(image_id), [])
        scores = [float(s) for s in scores]
        for i, s in enumerate(scores):
            rec = _to_record(
                image_id,
                s,
                None if boxes is None else boxes[i],
                None if masks is None else masks[i],
                1 if category_ids is None else list(category_ids)[i],
            )
            self._n += 1
            item = (float(s), self._n, rec)  # tie-break on insertion order
            if len(heap) < self.top_k:
                heapq.heappush(heap, item)
            else:
                heapq.heappushpop(heap, item)

    def flush(self, image_ids: Optional[Iterable[int]] = None):
        """Write (and drop) finished images; all buffered images if None."""
        ids = list(self._heaps.keys()) if image_ids is None else list(image_ids)
        with open(self.shard_path, "a") as f:
            for iid in ids:
                heap = self._heaps.pop(int(iid), None)
                if not heap:
                    continue
                for _, _, rec in sorted(heap, key=lambda t: -t[0]):
                    f.write(json.dumps(rec) + "\n")

    def finalize(self) -> str:
        self.flush()
        merged = os.path.join(self.out_dir, "predictions.jsonl")
        with open(merged, "w") as out:
            for shard in sorted(glob(os.path.join(self.out_dir, "preds_shard*.jsonl"))):
                with open(shard) as f:
                    for line in f:
                        out.write(line)
        return merged


def load_predictions(path: str) -> List[Dict]:
    """Read a dumped prediction file back into validate-CLI-shaped records
    (masks decoded lazily by the evaluators via the RLE dict)."""
    records = []
    with open(path) as f:
        for line in f:
            if line.strip():
                records.append(json.loads(line))
    return records


def evaluate_pred_file(
    pred_file: str,
    gts: Dict[int, List[Dict]],
    evaluators: Optional[Dict[str, Callable]] = None,
    iou_type: str = "segm",
) -> Dict[str, float]:
    """Offline evaluation of a dumped prediction file (reference
    ``CocoEvaluatorOfflineWithPredFileEvaluators`` coco_eval_offline.py):
    decodes RLE masks back into the in-memory dts structure the live eval
    consumes and runs COCO mAP + cgF1 (or custom ``evaluators``) on it.

    ``gts``: {image_id: [{"mask": HxW bool, "iscrowd": 0/1}, ...]} — the
    same GT dict the validate CLI builds.
    """
    from ..ops.rle import rle_decode
    from .cgf1 import evaluate_cgf1
    from .coco_map import evaluate_coco_map

    dts: Dict[int, List[Dict]] = {}
    for rec in load_predictions(pred_file):
        entry: Dict = {"score": rec["score"]}
        seg = rec.get("segmentation")
        if seg is not None:
            entry["mask"] = rle_decode(seg).astype(bool)
        if "bbox_xyxy" in rec:
            x0, y0, x1, y1 = rec["bbox_xyxy"]
            entry["box"] = [x0, y0, x1 - x0, y1 - y0]  # xywh for bbox IoU
        dts.setdefault(rec["image_id"], []).append(entry)

    if evaluators is not None:
        return {name: fn(gts, dts) for name, fn in evaluators.items()}
    out = evaluate_coco_map(gts, dts, iou_type=iou_type)
    out.update(evaluate_cgf1(gts, dts, iou_type=iou_type))
    return out
