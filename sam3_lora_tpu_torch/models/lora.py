"""LoRA adapters (port of ``sam3_lora_tpu/models/lora.py``): attach adapters
by the reference's name matching, and adapter-only ``.npz`` IO in the JAX
package's format, so adapter files move between the two packages.

An adapter file holds ``<module>.lora_a`` (in, r) and ``<module>.lora_b``
(r, out) in the JAX layout and channel order, under the JAX model's names:
with ``vit_scan_blocks`` (the default) the windowed ViT blocks' adapters are
stacked per scanned group (``scan_blocks_{g}.block.*``), as the JAX trainer
writes them. Loading takes either naming.

For training, ``trainable_parameters`` freezes the base and returns the
adapters, the only parameters that take a gradient. For serving with no
adapter cost, ``merge_lora_into_base`` folds the adapters into the base
weights (the reference's ``merge_weights``); ``lora_module_names`` lists
the adapted modules under the JAX model's names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import LoRAConfig

from ..parallel import fsdp
from .layers import LoRALinear

LORA_LEAF_NAMES = ("lora_a", "lora_b")


def apply_lora(model: nn.Module, lcfg: LoRAConfig) -> int:
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


def lora_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """Adapter tensors in the JAX layout and channel order."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, LoRALinear) and m.lora_a is not None:
            b = m.lora_b.detach().float().cpu()
            if m.out_perm is not None:
                unperm = torch.empty_like(b)
                unperm[m.out_perm] = b
                b = unperm
            out[f"{name}.lora_a"] = m.lora_a.detach().float().cpu().numpy().T.copy()
            out[f"{name}.lora_b"] = b.numpy().T.copy()
    return out


def trainable_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """Freeze every parameter but the adapters (``lora_a``, ``lora_b``);
    returns the adapters by name, in module order."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.endswith(LORA_LEAF_NAMES))
        if p.requires_grad:
            out.append((name, p))
    return out


def save_lora_weights(model: nn.Module, path: str) -> int:
    """Save only the adapter tensors as .npz, under the JAX model's names;
    returns the number of arrays saved."""
    from ..utils.checkpoint import stack_scanned

    state = lora_state(model)
    if model.spec.model.vit_scan_blocks:
        state = stack_scanned(state, model.spec.model)
    np.savez(path, **state)
    return len(state)


def load_lora_weights(model: nn.Module, path: str) -> int:
    """Replace the adapter tensors from an .npz (hot swap: the base weights
    stay where they are). Every key in the file must name an adapter of the
    model; returns the number loaded."""
    from ..utils.checkpoint import load_tensors, params_from_jax

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tensors = params_from_jax(flat)
    bad = [k for k in tensors if not k.endswith(LORA_LEAF_NAMES)]
    if bad:
        raise KeyError(f"not adapter tensors: {bad[:5]}")
    return load_tensors(model, tensors, strict=False)


def merge_lora_into_base(model: nn.Module) -> int:
    """Fold every adapter into its base weight and drop it: W <- W + (B A) *
    alpha/rank, in fp32, stored in the weight's dtype (the JAX
    ``merge_lora_into_base``). The layer then runs its plain product: K4,
    not K5, once ``prequantize_model`` quantizes the merged base. ``weight``
    and ``lora_b`` hold their rows in the same (``out_perm``) order. An int8
    (prequantized) weight raises, before anything changes: merge the float
    base, then quantize. A sharded weight (``parallel.shard_params_``) takes
    its slice of the adapters' product, so it holds its slice of the merged
    weight, with no collective. Returns the number of adapters merged."""
    layers = [(name, m) for name, m in model.named_modules()
              if isinstance(m, LoRALinear) and m.lora_a is not None]
    int8 = [name for name, m in layers if m.weight.dtype == torch.int8]
    if int8:
        raise ValueError(f"{int8[0]}.weight is int8 (prequantized); merge the adapters before "
                         "prequantize_model")
    with torch.no_grad():
        for _, m in layers:
            delta = (m.lora_b.float() @ m.lora_a.float()) * m.scaling
            shard = fsdp.shard_of(m, "weight")
            if shard is not None:
                delta = fsdp.local(shard, delta)
            m.weight.copy_((m.weight.float() + delta).to(m.weight.dtype))
            m.lora_a = m.lora_b = None
    return len(layers)


def lora_module_names(model: nn.Module) -> List[str]:
    """The sorted names of the modules that carry adapters, as the JAX
    ``lora_module_names`` gives them: the windowed ViT blocks under their
    scanned group (``...trunk.scan_blocks_{g}.block.*``) when the config
    scans them."""
    from ..utils.checkpoint import scanned_name

    cfg = model.spec.model
    names = set()
    for name, m in model.named_modules():
        if isinstance(m, LoRALinear) and m.lora_a is not None:
            scanned = scanned_name(name, cfg) if cfg.vit_scan_blocks else None
            names.add(name if scanned is None else scanned[0])
    return sorted(names)
