"""Text-prompted inference engine (port of ``sam3_lora_tpu/inference.py``).

One eval forward per image and batch of prompts; the postprocess mirrors the
JAX engine: scores = sigmoid(pred_logits), threshold filter, cxcywh -> xyxy
at the original size, masks sigmoid > 0.5, bilinearly resized to the
original resolution and thresholded again.

``preprocess`` and the mask resize take numpy arrays and use
``torch.nn.functional.interpolate``; PIL is imported only to read an image
file or a PIL image, and matplotlib only by ``visualize``.

Adapter hot swap: ``load_adapters`` replaces only the LoRA tensors; the base
weights stay on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .config import LoRAConfig, ModelConfig

from .models import Batch, GeoPrompt, build_sam3_image_model, init_model
from .models.lora import load_lora_weights
from .models.tokenizer import get_default_tokenizer
from .ops.quant import prequantize_model
from .utils.checkpoint import load_base_checkpoint

# the production normalization of the JAX data pipeline (train/data.py)
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5

ImageLike = Union[str, np.ndarray, "PIL.Image.Image"]  # noqa: F821


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
    """(N, h, w) bool -> (N, H, W) bool, on the masks' device. The JAX engine
    resizes each mask as 0/255 uint8 with PIL ``BILINEAR`` and keeps > 127.5.
    This is the same filter (bilinear, widened when shrinking) in one float
    pass. PIL rounds to uint8 after each of its two passes, so the two
    disagree only on pixels within one grey level of the threshold."""
    up = F.interpolate(masks[:, None].float(), size=size, mode="bilinear",
                       align_corners=False, antialias=True)
    return up[:, 0] >= 0.5


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
        return load_lora_weights(self.model, path)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, token_ids: torch.Tensor):
        """-> scores (B, Q), presence (B,), boxes (B, Q, 4) cxcywh in [0, 1],
        mask probabilities (B, Q, m, m), all fp32."""
        b = token_ids.shape[0]
        batch = Batch(
            images=images,
            token_ids=token_ids,
            img_ids=torch.zeros((b,), dtype=torch.long, device=self.device),
            geo=GeoPrompt.empty(b, self.cfg.max_prompt_boxes, device=self.device),
        )
        out = self.model(batch)
        scores = torch.sigmoid(out["pred_logits"][-1][..., 0].float())
        presence = torch.sigmoid(out["presence_logit_dec"][-1][..., 0].float())
        boxes = out["pred_boxes"][-1].float()
        masks = torch.sigmoid(out["pred_masks"].float())
        return scores, presence, boxes, masks

    # ------------------------------------------------------------------ #
    def preprocess(self, image: ImageLike) -> Tuple[np.ndarray, Tuple[int, int]]:
        """-> normalized (1, 3, R, R) float32 and the original (H, W).

        The resize runs on uint8, as the JAX engine's PIL ``BILINEAR`` resize
        does: antialiased, and rounded to uint8 before the /255. It agrees
        with PIL to one grey level, on a few percent of the pixels at most."""
        arr = _to_array(image)
        orig_h, orig_w = arr.shape[:2]
        r = self.cfg.img_size
        x = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None]
        x = F.interpolate(x.contiguous(memory_format=torch.channels_last), size=(r, r),
                          mode="bilinear", align_corners=False, antialias=True)
        x = (x.float() / 255.0 - IMAGE_MEAN) / IMAGE_STD
        return x.contiguous().numpy(), (orig_h, orig_w)

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
        thr = self.threshold if threshold is None else threshold
        img, (orig_h, orig_w) = self.preprocess(image)
        token_ids = self.tokenizer(
            [p.lower() for p in prompts], context_length=self.cfg.text_context_length
        )
        scores, presence, boxes, masks = self._forward(
            torch.from_numpy(img).to(self.device),
            torch.from_numpy(np.asarray(token_ids, np.int64)).to(self.device),
        )
        if use_presence:
            scores = scores * presence[:, None]
        scores, boxes = scores.cpu().numpy(), boxes.cpu().numpy()

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
            m = masks[qi][torch.from_numpy(keep).to(masks.device)] > 0.5  # (N, mr, mr)
            if resize_masks:
                m = resize_masks_to(m, (orig_h, orig_w))
            results[qi] = {
                "prompt": prompt,
                "boxes": xyxy,
                "scores": scores[qi][keep],
                "masks": m.cpu().numpy(),
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
