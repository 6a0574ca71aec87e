"""A configuration file (``benchmark/configs/<name>.json``) as the program's
and the reference's dataclasses. The file holds every field of
``ModelConfig`` and ``LoRAConfig`` under ``model`` and ``lora``, and the
optimizer and loader settings of ``TrainConfig`` under ``train``."""

from __future__ import annotations

import dataclasses
from typing import Dict


def _fields(cls, d: Dict) -> Dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            out[f.name] = tuple(v) if isinstance(v, list) else v
    unknown = set(d) - set(out)
    if unknown:
        raise KeyError(f"{cls.__name__} has no {sorted(unknown)}")
    return out


def port_configs(config: Dict):
    """-> the program's (ModelConfig, LoRAConfig)."""
    from sam3_lora_tpu_torch.config import LoRAConfig, ModelConfig

    return ModelConfig(**_fields(ModelConfig, config["model"])), \
        LoRAConfig(**_fields(LoRAConfig, config["lora"]))


def ref_configs(config: Dict):
    """-> the reference's (ModelConfig, LoRAConfig)."""
    from .reference.config import LoRAConfig, ModelConfig

    return ModelConfig(**_fields(ModelConfig, config["model"])), \
        LoRAConfig(**_fields(LoRAConfig, config["lora"]))
