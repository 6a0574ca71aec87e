"""Model factory (port of ``sam3_lora_tpu/models/builder.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LoRAConfig, ModelConfig

from .layers import Spec
from .lora import apply_lora
from .sam3_image import Sam3Image


def build_sam3_image_model(
    config: Optional[ModelConfig] = None,
    lora: Optional[LoRAConfig] = None,
    device=None,
) -> Sam3Image:
    """Build the model with empty parameters on ``device``, with adapters on
    the modules ``lora`` targets; fill them with ``init_model`` or a
    checkpoint (``utils/checkpoint.py``). Returned in eval mode with every
    parameter frozen (this is the serving path)."""
    model = Sam3Image(Spec(model=config or ModelConfig(), lora=lora, device=device))
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
