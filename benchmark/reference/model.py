"""Build the reference model: the plain SAM3 image model in float32.

``build(model_cfg, lora_cfg, device)`` takes the configuration's own
dataclasses (``config.py``, a copy of the port's) and returns ``Sam3Image``
with float32 storage and compute, the frozen base and the adapters as the
configuration names them, and empty parameters: the benchmark fills them
(``benchmark/weights.py``) from the seed, the same values it gives the
program. TF32 is turned off for the process, so a float32 product is one.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import LoRAConfig, ModelConfig
from .layers import LoRALinear, Spec
from .sam3_image import Sam3Image


def apply_lora(model: torch.nn.Module, lcfg: LoRAConfig) -> int:
    """Attach adapters to every LoRALinear whose dotted name ``lcfg``
    targets; returns how many."""
    if lcfg.rank <= 0:
        return 0
    n = 0
    for name, m in model.named_modules():
        if isinstance(m, LoRALinear) and lcfg.should_apply(name):
            m.add_adapter(lcfg.rank, lcfg.alpha)
            n += 1
    return n


def build(model_cfg: ModelConfig, lora_cfg: LoRAConfig, device,
          dtype: str = "float32") -> Sam3Image:
    """``dtype``: the compute type of the activations (the control keeps the
    configuration's); parameters are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(model_cfg, dtype=dtype, param_dtype="float32")
    model = Sam3Image(Spec(model=cfg, lora=lora_cfg, device=torch.device(device)))
    apply_lora(model, lora_cfg)
    return model.eval().requires_grad_(False)


def trainable(model: torch.nn.Module):
    """The adapters by name, in module order, with every other parameter
    frozen."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.endswith(("lora_a", "lora_b")))
        if p.requires_grad:
            out.append((name, p))
    return out
