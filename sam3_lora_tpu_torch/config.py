"""Configuration of the port: the JAX package's dataclasses, shared as they are.

``sam3_lora_tpu/config.py`` imports neither JAX nor Flax, so both packages
read one definition of every model, LoRA and training option. Code of the
port, and scripts that drive it, import the names from here.
"""

from sam3_lora_tpu.config import (  # noqa: F401
    LoRAConfig,
    ModelConfig,
    TrainConfig,
    load_yaml_config,
    tiny_model_config,
)

__all__ = ["LoRAConfig", "ModelConfig", "TrainConfig", "load_yaml_config", "tiny_model_config"]
