"""Multi-step interactive grounding, the PCS refinement loop: the port's own
copy of ``sam3_lora_tpu/interactive.py`` (which imports no JAX), driving the
port's ``Sam3Processor``.

At eval time SAM3 runs ``num_interactive_steps_val + 1`` grounding passes
over one image; between passes a sampler turns the previous pass's errors
against the ground truth into corrective box prompts (1 = positive, 0 =
negative), and every stage's output is kept:

* a ground-truth object that no confident prediction covers (a *miss*)
  becomes a **positive** box prompt around the object;
* a confident prediction that covers no ground-truth object (a *false
  positive*) becomes a **negative** box prompt.

The backbone runs once per image (the processor's cache); each step grounds
the cached features again with the box prompts padded to
``max_prompt_boxes`` slots. The error analysis between steps (box IoU
matching) is host numpy on the fetched outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "ErrorDrivenBoxSampler",
    "InteractiveSession",
    "interactive_ground",
]


def _box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU, pure numpy (host-side)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def _cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


@dataclass
class ErrorDrivenBoxSampler:
    """Samples corrective box prompts from prediction-vs-GT errors.

    Mirrors the reference's eval-only ``interactive_prompt_sampler.sample``
    call signature in spirit: (previous output, targets, current prompt) ->
    grown prompt. All boxes are normalized cxcywh in [0, 1].
    """

    score_threshold: float = 0.5   # a prediction counts if score > this
    iou_threshold: float = 0.5     # covered iff IoU > this
    max_new_positives: int = 1     # prompts added per step (worst miss first)
    max_new_negatives: int = 1
    jitter: float = 0.0            # optional box-noise std (simulated user)

    def sample(
        self,
        pred_boxes: np.ndarray,    # (Q, 4) cxcywh, previous pass
        pred_scores: np.ndarray,   # (Q,)
        gt_boxes: np.ndarray,      # (G, 4) cxcywh targets
        prompt_boxes: List[np.ndarray],
        prompt_labels: List[int],
        rng: Optional[np.random.RandomState] = None,
    ) -> bool:
        """Appends new (box, label) prompts in place; True if any added."""
        conf = pred_scores > self.score_threshold
        preds_xyxy = _cxcywh_to_xyxy(np.asarray(pred_boxes, np.float32)[conf])
        gts_xyxy = _cxcywh_to_xyxy(np.asarray(gt_boxes, np.float32))
        iou = _box_iou_xyxy(gts_xyxy, preds_xyxy)  # (G, P)

        # don't re-prompt an object/region already prompted
        prompted_pos = _cxcywh_to_xyxy(
            np.asarray(
                [b for b, l in zip(prompt_boxes, prompt_labels) if l == 1]
                or np.zeros((0, 4)),
                np.float32,
            ).reshape(-1, 4)
        )
        prompted_neg = _cxcywh_to_xyxy(
            np.asarray(
                [b for b, l in zip(prompt_boxes, prompt_labels) if l == 0]
                or np.zeros((0, 4)),
                np.float32,
            ).reshape(-1, 4)
        )

        added = False
        # ---- misses -> positive prompts (worst coverage first) ----
        cover = iou.max(axis=1) if iou.shape[1] else np.zeros(len(gts_xyxy))
        order = np.argsort(cover)
        n_pos = 0
        for gi in order:
            if n_pos >= self.max_new_positives or cover[gi] > self.iou_threshold:
                break
            g = gts_xyxy[gi : gi + 1]
            if len(prompted_pos) and _box_iou_xyxy(g, prompted_pos).max() > 0.9:
                continue  # already prompted this object
            box = np.asarray(gt_boxes, np.float32)[gi].copy()
            if self.jitter > 0 and rng is not None:
                box[:2] += rng.randn(2).astype(np.float32) * self.jitter * box[2:]
                box[2:] *= 1.0 + rng.randn(2).astype(np.float32) * self.jitter
            prompt_boxes.append(np.clip(box, 0.0, 1.0))
            prompt_labels.append(1)
            n_pos += 1
            added = True

        # ---- false positives -> negative prompts (most confident first) ----
        if iou.shape[0]:
            fp_cover = iou.max(axis=0) if iou.shape[1] else np.zeros(0)
        else:  # no GT at all: every confident prediction is spurious
            fp_cover = np.zeros(iou.shape[1], np.float32)
        fp_scores = np.asarray(pred_scores, np.float32)[conf]
        fp_order = np.argsort(-fp_scores)
        n_neg = 0
        conf_boxes = np.asarray(pred_boxes, np.float32)[conf]
        for pi in fp_order:
            if n_neg >= self.max_new_negatives:
                break
            if fp_cover[pi] > self.iou_threshold:
                continue  # a real detection, leave it alone
            p = preds_xyxy[pi : pi + 1]
            if len(prompted_neg) and _box_iou_xyxy(p, prompted_neg).max() > 0.9:
                continue
            prompt_boxes.append(np.clip(conf_boxes[pi].copy(), 0.0, 1.0))
            prompt_labels.append(0)
            n_neg += 1
            added = True
        return added


class InteractiveSession:
    """Multi-step refinement over one image + text prompt.

    Drives a :class:`~sam3_lora_tpu_torch.processor.Sam3Processor` whose
    ``set_image`` has already been called: each ``step()`` re-grounds the
    cached backbone features with the accumulated geometric prompts and
    records the stage output (the reference's LAST_STEP_PER_STAGE list).
    """

    def __init__(
        self,
        processor,
        prompt: str,
        gt_boxes: np.ndarray,
        sampler: Optional[ErrorDrivenBoxSampler] = None,
        threshold: Optional[float] = None,
        seed: int = 0,
    ):
        self.processor = processor
        self.prompt = prompt
        self.gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        self.sampler = sampler or ErrorDrivenBoxSampler()
        self.threshold = threshold
        self.rng = np.random.RandomState(seed)
        self.prompt_boxes: List[np.ndarray] = []
        self.prompt_labels: List[int] = []
        self.stage_outputs: List[Dict[str, Any]] = []

    def _normalized_pred(self, out: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Back to normalized cxcywh for the sampler."""
        orig_h, orig_w = self.processor._state["orig_size"]
        xyxy = np.asarray(out["boxes"], np.float32).reshape(-1, 4)
        norm = xyxy / np.array([orig_w, orig_h, orig_w, orig_h], np.float32)
        cxcywh = np.stack(
            [
                (norm[:, 0] + norm[:, 2]) / 2,
                (norm[:, 1] + norm[:, 3]) / 2,
                norm[:, 2] - norm[:, 0],
                norm[:, 3] - norm[:, 1],
            ],
            axis=-1,
        )
        return {"boxes": cxcywh, "scores": np.asarray(out["scores"], np.float32)}

    def step(self) -> Dict[str, Any]:
        """One grounding pass with the current prompts; returns its output."""
        cap = self.processor.cfg.max_prompt_boxes
        boxes = (
            np.stack(self.prompt_boxes[:cap]) if self.prompt_boxes else None
        )
        labels = self.prompt_labels[:cap] if self.prompt_labels else None
        out = self.processor.set_text_prompt(
            self.prompt, boxes=boxes, box_labels=labels, threshold=self.threshold
        )
        out["prompt_boxes"] = [b.copy() for b in self.prompt_boxes]
        out["prompt_labels"] = list(self.prompt_labels)
        self.stage_outputs.append(out)
        return out

    def refine(self) -> bool:
        """Sample corrective prompts from the last stage; True if any added."""
        if not self.stage_outputs:
            raise RuntimeError("call step() before refine()")
        pred = self._normalized_pred(self.stage_outputs[-1])
        return self.sampler.sample(
            pred["boxes"],
            pred["scores"],
            self.gt_boxes,
            self.prompt_boxes,
            self.prompt_labels,
            rng=self.rng,
        )

    def run(self, num_interactive_steps: int) -> List[Dict[str, Any]]:
        """The reference loop: 1 + num_interactive_steps stages
        (sam3_image.py:559-575). Stops early once the sampler finds no
        remaining errors."""
        self.step()
        for _ in range(num_interactive_steps):
            if not self.refine():
                break
            self.step()
        return self.stage_outputs


def interactive_ground(
    processor,
    image,
    prompt: str,
    gt_boxes: np.ndarray,
    num_interactive_steps: int = 2,
    sampler: Optional[ErrorDrivenBoxSampler] = None,
    threshold: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """One-call convenience: set the image, run the multi-step loop, return
    the per-stage output list (first entry = plain single-step grounding)."""
    processor.set_image(image)
    sess = InteractiveSession(
        processor, prompt, gt_boxes, sampler=sampler, threshold=threshold
    )
    return sess.run(num_interactive_steps)
