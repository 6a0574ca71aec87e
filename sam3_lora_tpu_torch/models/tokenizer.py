"""The JAX package's CLIP BPE tokenizer, reused as it is.

``sam3_lora_tpu/models/__init__.py`` imports the Flax model, so the module is
loaded by file path instead of through its package; it finds its vocab file
from its own location.
"""

from __future__ import annotations

import functools
import importlib.util
import os

import sam3_lora_tpu

_PATH = os.path.join(os.path.dirname(sam3_lora_tpu.__file__), "models", "tokenizer.py")


@functools.lru_cache(maxsize=1)
def _module():
    spec = importlib.util.spec_from_file_location("_sam3_bpe_tokenizer", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_default_tokenizer():
    return _module().get_default_tokenizer()
