"""Stateful serving API (port of ``sam3_lora_tpu/processor.py``):
``set_image`` runs the ViT+FPN backbone once and caches its features (copies
out of the engine's graph pool on the card: ``graphs.py``); each
``set_text_prompt`` / ``add_geometric_prompt`` then grounds one prompt
against the cache (text encoder, geometry encoder, fusion encoder, decoder
and heads: no backbone rerun).

Scores follow the processor's semantics, ``sigmoid(logit) *
sigmoid(presence)`` above the threshold, where ``SAM3LoRAInference.predict``
thresholds the plain sigmoid; both surfaces are kept.

The model is built as ``SAM3LoRAInference`` builds it (on CUDA unless the
caller passes ``device="cpu"``; base checkpoint, adapters, and the int8
base quantized once when ``base_quant`` asks for it), and the image goes
through its preprocess (``inference.py::preprocess_image``, on the device):
the same tensor ``predict`` feeds the model, with no PIL for an array.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .config import LoRAConfig, ModelConfig
from .inference import ImageLike, SAM3LoRAInference, preprocess_image
from .models import Batch, GeoPrompt
from .utils.logging import to_device, to_host, trace_span


class Sam3Processor:
    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        lora_cfg: Optional[LoRAConfig] = None,
        weights: Optional[str] = None,
        base_checkpoint: Optional[str] = None,
        threshold: float = 0.5,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.engine = SAM3LoRAInference(model_cfg, lora_cfg, weights=weights,
                                        base_checkpoint=base_checkpoint, seed=seed,
                                        device=device)
        self.cfg, self.model, self.device = self.engine.cfg, self.engine.model, self.engine.device
        self.tokenizer = self.engine.tokenizer
        self.threshold = threshold
        self._state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def set_image(self, image: ImageLike) -> "Sam3Processor":
        with trace_span("sam3.set_image"):
            with trace_span("sam3.preprocess"):
                img, orig_size = preprocess_image(image, self.cfg.img_size, self.device)
            with trace_span("sam3.forward"):
                feats, poss = self.engine.backbone_image(img)
            self._state = {"feats": feats, "poss": poss, "orig_size": orig_size}
        return self

    # ------------------------------------------------------------------ #
    def geo_prompt(self, boxes: Optional[np.ndarray] = None,
                   box_labels: Optional[Sequence[int]] = None) -> GeoPrompt:
        """One row of box prompts, padded to ``max_prompt_boxes`` slots (the
        extra boxes dropped); no boxes: the empty prompt."""
        p = self.cfg.max_prompt_boxes
        if boxes is None or not len(boxes):
            return GeoPrompt.empty(1, p, device=self.device)
        n = min(len(boxes), p)
        labels = (np.asarray(box_labels[:n], np.int64) if box_labels is not None
                  else np.ones((n,), np.int64))
        as_t = lambda a: to_device(torch.from_numpy(a)[None], self.device, "geo")  # noqa: E731
        return GeoPrompt(
            boxes=as_t(np.pad(np.asarray(boxes[:n], np.float32), ((0, p - n), (0, 0)))),
            mask=as_t(np.arange(p) >= n),
            labels=as_t(np.pad(labels, (0, p - n), constant_values=1)),
        )

    @torch.inference_mode()
    def ground(self, prompt: str, geo: GeoPrompt):
        """One prompt against the cached image -> scores (1, Q), presence
        (1,), boxes (1, Q, 4) cxcywh in [0, 1], mask probabilities (1, Q, m,
        m), as ``SAM3LoRAInference._forward`` gives them."""
        if self._state is None:
            raise RuntimeError("call set_image() first")
        return self._ground(self._tokens(prompt), geo)

    def _tokens(self, prompt: str) -> torch.Tensor:
        ids = self.tokenizer([prompt.lower()], context_length=self.cfg.text_context_length)
        return to_device(torch.from_numpy(np.asarray(ids, np.int64)), self.device, "tokens")

    @torch.inference_mode()
    def _ground(self, token_ids: torch.Tensor, geo: GeoPrompt):
        batch = Batch(images=None, token_ids=token_ids,
                      img_ids=torch.zeros((1,), dtype=torch.long, device=self.device), geo=geo)
        return self.engine.ground(self._state["feats"], self._state["poss"], batch)

    def set_text_prompt(
        self,
        prompt: str,
        boxes: Optional[np.ndarray] = None,
        box_labels: Optional[Sequence[int]] = None,
        threshold: Optional[float] = None,
        mask_prompt: Optional[np.ndarray] = None,
    ) -> Dict[str, Any]:
        """Ground one text prompt (and optional box prompts, normalized
        cxcywh in [0, 1], and one mask prompt, an (H, W) binary or float
        mask at any resolution, which needs ``geo_mask_prompts``) against
        the cached image. -> prompt, scores (N,), boxes (N, 4) xyxy in
        original pixels, masks_lowres (N, m, m) bool, presence,
        num_detections."""
        if self._state is None:
            raise RuntimeError("call set_image() first")
        with trace_span("sam3.set_text_prompt"):
            thr = self.threshold if threshold is None else threshold
            with trace_span("sam3.preprocess"):
                geo = self.geo_prompt(boxes, box_labels)
                if mask_prompt is not None:
                    if not self.cfg.geo_mask_prompts:
                        raise ValueError("mask prompts need ModelConfig(geo_mask_prompts=True)")
                    m = to_device(torch.from_numpy(np.asarray(mask_prompt, np.float32)),
                                  self.device, "mask_prompt")
                    geo = dataclasses.replace(
                        geo, mask_embeddings=m[None, None],
                        mask_mask=torch.zeros((1, 1), dtype=torch.bool, device=self.device),
                        mask_labels=torch.ones((1, 1), dtype=torch.long, device=self.device))
                token_ids = self._tokens(prompt)
            with trace_span("sam3.forward"):
                scores, presence, boxes_out, masks = self._ground(token_ids, geo)
            with trace_span("sam3.post"):
                pres = float(to_host(presence[0], "presence"))
                s = to_host(scores[0], "scores").numpy() * pres
                keep = s > thr
                orig_h, orig_w = self._state["orig_size"]
                cx, cy, w, h = to_host(boxes_out[0], "boxes").numpy()[keep].T
                xyxy = np.stack([(cx - w / 2) * orig_w, (cy - h / 2) * orig_h,
                                 (cx + w / 2) * orig_w, (cy + h / 2) * orig_h], axis=-1)
                low = masks[0][to_device(torch.from_numpy(keep), masks.device, "keep")] > 0.5
                low = to_host(low, "masks").numpy()
        return {
            "prompt": prompt,
            "scores": s[keep],
            "boxes": xyxy,
            "masks_lowres": low,
            "presence": pres,
            "num_detections": int(keep.sum()),
        }

    # ------------------------------------------------------------------ #
    def add_geometric_prompt(
        self, prompt: str, boxes: np.ndarray, labels: Optional[Sequence[int]] = None
    ) -> Dict[str, Any]:
        return self.set_text_prompt(prompt, boxes=boxes, box_labels=labels)
