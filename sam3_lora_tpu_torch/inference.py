"""Text-prompted inference engine (port of ``sam3_lora_tpu/inference.py``).

One eval forward per image and batch of prompts; the postprocess mirrors the
JAX engine: scores = sigmoid(pred_logits), threshold filter, cxcywh -> xyxy
at the original size, masks sigmoid > 0.5, bilinearly resized to the
original resolution and thresholded again.

The image and mask resizes are PIL's ``BILINEAR``, as the JAX engine runs
them on the host, computed on the engine's device pixel for pixel
(``ops/interpolate.py::resize_pil_bilinear``); PIL is imported only to read
an image file or a PIL image, and matplotlib only by ``visualize``.

Adapter hot swap: ``load_adapters`` replaces only the LoRA tensors; the base
weights stay on the device.

On the card the forward's two units, the image backbone and the grounding
(with ``head_outputs``), replay CUDA graphs from the engine's ``GraphCache``
(``graphs.py``): one a shape, captured at its first call; the processor
shares them through its engine.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import LoRAConfig, ModelConfig
from .graphs import GraphCache
from .models import Batch, GeoPrompt, build_sam3_image_model, init_model
from .models.lora import load_lora_weights
from .models.tokenizer import get_default_tokenizer
from .ops.interpolate import resize_pil_bilinear
from .ops.quant import prequantize_model
from .utils.checkpoint import load_base_checkpoint
from .utils.logging import to_device, to_host, trace_span

# the production normalization of the JAX data pipeline (train/data.py)
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5

ImageLike = Union[str, np.ndarray, "PIL.Image.Image"]  # noqa: F821

# (v / 255 - mean) / std of every uint8 value v, in float32 as the JAX
# engine's numpy computes it: looked up, so that every device gives these
# values (CUDA divides by a scalar as a product with its reciprocal)
NORMALIZED = (np.arange(256, dtype=np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD


@functools.lru_cache(maxsize=8)
def _normalized_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(NORMALIZED).to(device)


def _to_array(image: ImageLike) -> np.ndarray:
    """-> (H, W, 3) uint8. PIL is needed only for a path or a PIL image."""
    if isinstance(image, np.ndarray):
        arr = image.astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return arr[..., :3]
    from PIL import Image as PILImage

    if isinstance(image, str):
        image = PILImage.open(image)
    return np.array(image.convert("RGB"), np.uint8)


def resize_masks_to(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, h, w) bool -> (N, H, W) bool, on the masks' device: the JAX
    engine's resize, each mask as 0/255 uint8 through PIL ``BILINEAR``,
    kept where > 127.5."""
    up = resize_pil_bilinear(masks.to(torch.uint8) * 255, size)
    return up > 127.5


def preprocess_image(image: ImageLike, img_size: int, device: Union[str, torch.device]
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """-> normalized (1, 3, R, R) float32 on ``device`` and the original
    (H, W): the JAX engine's preprocess, PIL ``BILINEAR`` to R x R on uint8,
    then (x / 255 - 0.5) / 0.5 (``NORMALIZED``), the same float32 values.
    Only the uint8 image crosses to the device."""
    arr = _to_array(image)
    x = to_device(torch.from_numpy(np.ascontiguousarray(arr)), device, "image")
    x = resize_pil_bilinear(x, (img_size, img_size), dims=(0, 1))
    return _normalized_on(x.device)[x.permute(2, 0, 1)[None].long()], arr.shape[:2]


def head_outputs(out: Dict[str, Any]):
    """The model's output dict -> scores (B, Q), presence (B,), boxes
    (B, Q, 4) cxcywh in [0, 1] and mask probabilities (B, Q, m, m), all
    fp32, from the last decoder layer."""
    scores = torch.sigmoid(out["pred_logits"][-1][..., 0].float())
    presence = torch.sigmoid(out["presence_logit_dec"][-1][..., 0].float())
    boxes = out["pred_boxes"][-1].float()
    masks = torch.sigmoid(out["pred_masks"].float())
    return scores, presence, boxes, masks


class SAM3LoRAInference:
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
        self.cfg = model_cfg or ModelConfig(dtype="bfloat16")
        self.lcfg = lora_cfg
        self.threshold = threshold
        self.device = torch.device(device)  # the card unless the caller asks for the CPU
        self.model = build_sam3_image_model(self.cfg, lora=lora_cfg, device=self.device)
        self.graphs = GraphCache(self.model)
        self.tokenizer = get_default_tokenizer()
        init_model(self.model, torch.Generator(device=self.device).manual_seed(seed))
        if base_checkpoint:
            load_base_checkpoint(self.model, base_checkpoint)
        if weights:
            self.load_adapters(weights)
        if self.cfg.base_quant != "none":
            # quantize the frozen base once, at load: the same numbers as the
            # per-call quantization, int8 weights in device memory
            prequantize_model(self.model, self.cfg.base_quant_min_dim)

    # ------------------------------------------------------------------ #
    def load_adapters(self, path: str) -> int:
        return load_lora_weights(self.model, path)  # in place: the graphs read the new values

    # ------------------------------------------------------------------ #
    def backbone_image(self, images: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``Sam3Image.backbone_image``, from a CUDA graph where the cache
        engages."""
        if not self.graphs.engages(images):
            return self.model.backbone_image(images)

        def unit(x):
            feats, poss = self.model.backbone_image(x)
            return feats + poss

        out = self.graphs.run("backbone", unit, [images])
        return out[:len(out) // 2], out[len(out) // 2:]

    def ground(self, feats: Sequence[torch.Tensor], poss: Sequence[torch.Tensor], batch: Batch):
        """``head_outputs`` of ``Sam3Image.ground``, from a CUDA graph where
        the cache engages (no training targets): scores (B, Q), presence
        (B,), boxes (B, Q, 4) cxcywh in [0, 1], mask probabilities (B, Q, m,
        m), all fp32."""
        if batch.targets is not None or not self.graphs.engages(*feats, *poss, batch.token_ids):
            return head_outputs(self.model.ground(feats, poss, batch))
        n, geo = len(feats), batch.geo
        fields = None if geo is None else tuple(
            f.name for f in dataclasses.fields(GeoPrompt) if getattr(geo, f.name) is not None)

        def unit(*xs):
            g = None if fields is None else GeoPrompt(**dict(zip(fields, xs[2 * n + 2:])))
            b = Batch(images=None, token_ids=xs[2 * n], img_ids=xs[2 * n + 1], geo=g)
            return head_outputs(self.model.ground(list(xs[:n]), list(xs[n:2 * n]), b))

        inputs = [*feats, *poss, batch.token_ids, batch.img_ids,
                  *(getattr(geo, f) for f in fields or ())]
        return tuple(self.graphs.run("ground", unit, inputs, tag=fields))

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, token_ids: torch.Tensor):
        """-> scores (B, Q), presence (B,), boxes (B, Q, 4) cxcywh in [0, 1],
        mask probabilities (B, Q, m, m), all fp32. One image: every prompt
        on it; B images (a batch of frames): prompt i on image i. (The JAX
        engine points every row at image 0, so its frame-parallel detector
        would ground every frame of a chunk on the first.)"""
        b = token_ids.shape[0]
        one_each = images.shape[0] == b
        batch = Batch(
            images=images,
            token_ids=token_ids,
            img_ids=(torch.arange if one_each else torch.zeros)(b, dtype=torch.long,
                                                                 device=self.device),
            geo=GeoPrompt.empty(b, self.cfg.max_prompt_boxes, device=self.device),
        )
        feats, poss = self.backbone_image(images)
        return self.ground(feats, poss, batch)

    # ------------------------------------------------------------------ #
    def preprocess(self, image: ImageLike) -> Tuple[np.ndarray, Tuple[int, int]]:
        """-> normalized (1, 3, R, R) float32 numpy and the original (H, W),
        equal to the JAX engine's ``preprocess``: ``preprocess_image`` on
        this engine's device, brought back to the host. ``predict`` and the
        processor call ``preprocess_image`` and keep the image on the
        device; this numpy form is for callers that batch frames on the host
        (the frame-parallel detector's inputs in the tests and in
        chip_smoke.py)."""
        x, hw = preprocess_image(image, self.cfg.img_size, self.device)
        return x.cpu().numpy(), hw

    # ------------------------------------------------------------------ #
    def predict(
        self,
        image: ImageLike,
        prompts: Sequence[str],
        threshold: Optional[float] = None,
        use_presence: bool = False,
        resize_masks: bool = True,
    ) -> Dict[int, Dict[str, Any]]:
        """Run all prompts against one image (one backbone pass, batched text).

        Returns {prompt_idx: {prompt, boxes (N, 4) xyxy at the original
        scale, scores (N,), masks (N, H, W) bool at the original size,
        num_detections}}.
        """
        with trace_span("sam3.predict"):
            thr = self.threshold if threshold is None else threshold
            with trace_span("sam3.preprocess"):
                img, (orig_h, orig_w) = preprocess_image(image, self.cfg.img_size, self.device)
                token_ids = self.tokenizer(
                    [p.lower() for p in prompts], context_length=self.cfg.text_context_length
                )
                token_ids = to_device(torch.from_numpy(np.asarray(token_ids, np.int64)),
                                      self.device, "tokens")
            with trace_span("sam3.forward"):
                scores, presence, boxes, masks = self._forward(img, token_ids)
            with trace_span("sam3.post"):
                if use_presence:
                    scores = scores * presence[:, None]
                scores, boxes = to_host(scores, "scores").numpy(), to_host(boxes, "boxes").numpy()

                results: Dict[int, Any] = {}
                for qi, prompt in enumerate(prompts):
                    keep = scores[qi] > thr
                    n = int(keep.sum())
                    if n == 0:
                        results[qi] = {
                            "prompt": prompt, "boxes": None, "scores": None,
                            "masks": None, "num_detections": 0,
                        }
                        continue
                    cx, cy, w, h = boxes[qi][keep].T
                    xyxy = np.stack(
                        [(cx - w / 2) * orig_w, (cy - h / 2) * orig_h,
                         (cx + w / 2) * orig_w, (cy + h / 2) * orig_h],
                        axis=-1,
                    )
                    m = masks[qi][to_device(torch.from_numpy(keep), masks.device, "keep")] > 0.5
                    if resize_masks:
                        m = resize_masks_to(m, (orig_h, orig_w))
                    results[qi] = {
                        "prompt": prompt,
                        "boxes": xyxy,
                        "scores": scores[qi][keep],
                        "masks": to_host(m, "masks").numpy(),
                        "num_detections": n,
                    }
        return results

    # ------------------------------------------------------------------ #
    def visualize(
        self,
        image: ImageLike,
        results: Dict[int, Dict[str, Any]],
        output_path: str,
        show_boxes: bool = True,
        show_masks: bool = True,
    ) -> str:
        """Overlay detections and save the figure (needs matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 1, figsize=(12, 8))
        ax.imshow(_to_array(image))
        cmap = plt.get_cmap("tab10")
        for qi, res in results.items():
            if res["num_detections"] == 0:
                continue
            color = cmap(qi % 10)
            for i in range(res["num_detections"]):
                if show_masks and res["masks"] is not None:
                    mask = res["masks"][i]
                    overlay = np.zeros((*mask.shape, 4))
                    overlay[mask] = (*color[:3], 0.45)
                    ax.imshow(overlay)
                if show_boxes:
                    x1, y1, x2, y2 = res["boxes"][i]
                    ax.add_patch(plt.Rectangle(
                        (x1, y1), x2 - x1, y2 - y1, fill=False, edgecolor=color, linewidth=2,
                    ))
                    ax.text(
                        x1, max(y1 - 4, 0), f"{res['prompt']} {res['scores'][i]:.2f}",
                        color="white", fontsize=9, bbox=dict(facecolor=color, alpha=0.8, pad=1),
                    )
        ax.axis("off")
        fig.savefig(output_path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return output_path
