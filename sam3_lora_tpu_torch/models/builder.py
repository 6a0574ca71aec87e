"""Model factory (port of ``sam3_lora_tpu/models/builder.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LoRAConfig, ModelConfig

from .geometry import GeoPrompt
from .layers import Spec
from .lora import apply_lora
from .sam3_image import Batch, Sam3Image, Targets


def build_sam3_image_model(
    config: Optional[ModelConfig] = None,
    lora: Optional[LoRAConfig] = None,
    device=None,
) -> Sam3Image:
    """Build the model with empty parameters on ``device``, with adapters on
    the modules ``lora`` targets; fill them with ``init_model`` or a
    checkpoint (``utils/checkpoint.py``). Returned in eval mode with every
    parameter frozen (this is the serving path)."""
    config = config or ModelConfig()
    if config.base_quant not in ("none", "int8", "int8_bwd"):
        raise ValueError(f"unknown base_quant: {config.base_quant!r}")
    model = Sam3Image(Spec(model=config, lora=lora, device=device))
    if lora is not None:
        apply_lora(model, lora)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def init_model(model: Sam3Image, generator: torch.Generator) -> Sam3Image:
    """Seeded random init at any config: each module fills its own
    parameters from ``generator`` (which must be on the parameters' device),
    in module order."""
    for m in model.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)
    return model


def dummy_batch(
    cfg: ModelConfig,
    batch_size: int = 1,
    with_targets: bool = False,
    num_images: Optional[int] = None,
    device=None,
) -> Batch:
    """A zero batch of the config's shapes (JAX ``builder.dummy_batch``): one
    start/end-token prompt per row, a padded mask prompt when the config
    takes them and, with targets, one centred box with an empty mask per
    row."""
    n_img = num_images or batch_size
    r, t, m = cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    targets = None
    if with_targets:
        first = torch.zeros((batch_size, t), dtype=torch.bool, device=device)
        first[:, 0] = True
        targets = Targets(
            boxes=torch.tensor([0.5, 0.5, 0.25, 0.25], device=device).repeat(batch_size, t, 1),
            valid=first,
            masks=torch.zeros((batch_size, t, m, m), device=device),
            mask_valid=first.clone(),
            is_exhaustive=torch.ones((batch_size,), dtype=torch.bool, device=device),
        )
    token_ids = torch.zeros((batch_size, cfg.text_context_length), dtype=torch.long,
                            device=device)
    token_ids[:, 0], token_ids[:, 1] = 49406, 49407
    geo = GeoPrompt.empty(batch_size, cfg.max_prompt_boxes, device=device)
    if cfg.geo_mask_prompts:
        geo.mask_embeddings = torch.zeros((batch_size, 1, r, r), device=device)
        geo.mask_mask = torch.ones((batch_size, 1), dtype=torch.bool, device=device)
        geo.mask_labels = torch.ones((batch_size, 1), dtype=torch.long, device=device)
    return Batch(
        images=torch.zeros((n_img, 3, r, r), device=device),
        token_ids=token_ids,
        img_ids=torch.arange(batch_size, device=device) % n_img,
        geo=geo,
        targets=targets,
    )
