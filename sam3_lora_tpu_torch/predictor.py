"""Interactive image predictor (port of ``sam3_lora_tpu/predictor.py``): set
an image once (the processor's cached backbone pass), then predict instance
masks from point and box prompts through the SAM heads of a
``TrackerCore``.

Prompts are padded to ``MAX_POINTS`` slots with label -1, and a box becomes
its two corners with labels 2 and 3. The no-memory embedding is added to
the lowest-resolution feature map, as the reference's image task does; the
two high-resolution maps go to the mask decoder's own projections. The
low-resolution masks are upscaled to the original image size with
half-pixel bilinear sampling (``jax.image.resize(..., "bilinear")``'s).

The heads run on the processor's device (CUDA unless the processor was
built with ``device="cpu"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.builder import init_model
from .models.layers import Spec
from .models.tracker import TrackerCore
from .ops.interpolate import resize_bilinear
from .utils.checkpoint import load_jax_tree

MAX_POINTS = 8  # point-prompt slots (padded with label -1)

# the parameters of TrackerCore that a prediction does not run: a param tree
# from the JAX predictor's init holds none of them
PREDICT_UNUSED = ("transformer.", "maskmem_backbone.", "obj_ptr_proj.", "obj_ptr_tpos_proj.",
                  "mask_downsample.", "sam_prompt_encoder.mask_downscaling.")


def tracker_core(cfg, device, num_maskmem: int = 7, max_obj_ptrs: int = 16) -> TrackerCore:
    """The ``TrackerCore`` for ``cfg`` on ``device`` (empty parameters): its
    heads at d_model over the stride-14 grid, memory at d_model / 4."""
    fh = cfg.img_size // cfg.patch_size
    return TrackerCore(Spec(model=cfg, lora=None, device=device), d_model=cfg.d_model,
                       mem_dim=max(cfg.d_model // 4, 8), feat_sizes=(fh, fh),
                       num_maskmem=num_maskmem, max_obj_ptrs=max_obj_ptrs)


class SAM3InteractiveImagePredictor:
    """Click- and box-driven instance segmentation of one image.

    ``processor``: a ``Sam3Processor`` (the shared backbone and its device).
    ``tracker_params``: a JAX ``TrackerCore`` param tree (numpy or jax
    arrays; the parameters a prediction runs must all be there), loaded
    through the weight bridge; None draws the port's own seeded init.
    """

    def __init__(self, processor, tracker_params: Optional[Mapping[str, Any]] = None,
                 mask_threshold: float = 0.0, seed: int = 0):
        self.proc = processor
        cfg = self.cfg = processor.cfg
        self.device = processor.device
        self.mask_threshold = mask_threshold
        self.core = tracker_core(cfg, self.device)
        if tracker_params is None:
            init_model(self.core, torch.Generator(device=self.device).manual_seed(seed))
        else:
            load_jax_tree(self.core, tracker_params, optional=PREDICT_UNUSED)
        self.core.eval().requires_grad_(False)
        self._features: Optional[Dict[str, torch.Tensor]] = None
        self._orig_size: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------------ #
    def set_image(self, image) -> "SAM3InteractiveImagePredictor":
        """Run the backbone once and cache the three feature maps the heads read."""
        self.proc.set_image(image)
        st = self.proc._state
        feats = st["feats"]
        self._features = {"vis": feats[-1], "hi0": feats[0], "hi1": feats[1]}
        self._orig_size = st["orig_size"]
        return self

    def reset_predictor(self) -> None:
        self._features = None
        self._orig_size = None

    def get_image_embedding(self) -> np.ndarray:
        if self._features is None:
            raise RuntimeError("call set_image first")
        return self._features["vis"].float().cpu().numpy()

    # ------------------------------------------------------------------ #
    def _prep_prompts(self, point_coords: Optional[np.ndarray], point_labels: Optional[np.ndarray],
                      box: Optional[np.ndarray], normalize_coords: bool = True):
        """Pad to MAX_POINTS slots; a box first, as its corners with labels
        2 and 3. -> coords (1, MAX_POINTS, 2), labels (1, MAX_POINTS) on the
        device, in model-input pixels."""
        oh, ow = self._orig_size
        r = self.cfg.img_size
        coords = np.zeros((MAX_POINTS, 2), np.float32)
        labels = np.full((MAX_POINTS,), -1, np.int64)
        n = 0
        if box is not None:
            coords[0:2] = np.asarray(box, np.float32).reshape(2, 2)
            labels[0:2] = (2, 3)
            n = 2
        if point_coords is not None:
            pc = np.asarray(point_coords, np.float32).reshape(-1, 2)
            pl = np.asarray(point_labels, np.int64).reshape(-1)
            m = min(len(pc), MAX_POINTS - n)
            coords[n:n + m] = pc[:m]
            labels[n:n + m] = pl[:m]
        if normalize_coords:
            coords = coords * np.array([r / ow, r / oh], np.float32)
        return (torch.from_numpy(coords[None]).to(self.device),
                torch.from_numpy(labels[None]).to(self.device))

    @torch.inference_mode()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False,
                normalize_coords: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (masks (M, H, W) at the original size, bool or logits with
        ``return_logits``; iou_predictions (M,); low_res_masks (M, h, w)
        logits), M = 3 with ``multimask_output``, else 1."""
        if self._features is None:
            raise RuntimeError("call set_image first")
        coords, labels = self._prep_prompts(point_coords, point_labels, box, normalize_coords)
        f = self._features
        cond = self.core.no_memory_features(f["vis"])
        masks, iou, _, _ = self.core.predict_masks(cond, [f["hi0"], f["hi1"]], point_coords=coords,
                                                   point_labels=labels,
                                                   multimask_output=bool(multimask_output))
        low = masks[0].float()
        up = resize_bilinear(low, self._orig_size, antialias=True)
        if not return_logits:
            up = up > self.mask_threshold
        return up.cpu().numpy(), iou[0].float().cpu().numpy(), low.cpu().numpy()

    def predict_batch(self, images: List, point_coords_batch: List, point_labels_batch: List,
                      multimask_output: bool = True):
        """One ``set_image`` and one ``predict`` per image, in turn."""
        out = []
        for img, pc, pl in zip(images, point_coords_batch, point_labels_batch):
            self.set_image(img)
            out.append(self.predict(pc, pl, multimask_output=multimask_output))
        return out
