"""Seeded weights of a configuration, made by the benchmark and handed alike
to the program and to the reference.

The leaves are those of the reference model (``benchmark/reference``), in
name order. One ``torch.randn`` call on the device, in the storage type,
draws every value; each leaf's slice is then scaled in place by a rule on
its module and name: a fan-in scale for the products' weights, 1 +/- 0.02
for the norms' gains, 0.02 for biases and embeddings that have no scale of
their own, and small nonzero adapters (``lora_b`` at 0.01), so that every
adapter takes a gradient from the first step.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

LoRA_B_STD = 0.01


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one use of the run's ``--seed``: any whole number, also
    beyond 64 bits, gives a seed below ``2**bits``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)


def _rule(module: torch.nn.Module, leaf: str, shape) -> Tuple[float, float]:
    """(mean, std) of one leaf."""
    kind = type(module).__name__
    if leaf == "lora_a":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if leaf == "lora_b":
        return 0.0, LoRA_B_STD
    if kind in ("LayerNorm", "GroupNorm"):
        return (1.0 if leaf == "weight" else 0.0), 0.02
    if leaf.endswith("bias"):
        return 0.0, 0.02
    if kind == "Embedding":
        return 0.0, float(module.std)
    if kind == "Conv2d" and getattr(module, "trunc_std", None) is not None:
        return 0.0, float(module.trunc_std)
    if kind == "ConvTranspose2x2":  # (in, out, 2, 2), stride 2: an output sums ``in`` terms
        return 0.0, 1.0 / math.sqrt(shape[0])
    if leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    return 0.0, 0.02


def leaves(ref_model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter of ``ref_model``, by name."""
    out = []
    for mname, module in ref_model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            out.append((name, tuple(p.shape), *_rule(module, leaf, tuple(p.shape))))
    return sorted(out)


def make(spec: List[Tuple[str, Tuple[int, ...], float, float]], seed: int, dtype: torch.dtype,
         device) -> Dict[str, torch.Tensor]:
    """{name: tensor} in ``dtype`` on ``device``, views of one draw."""
    n = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=torch.device(device)).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(n, generator=g, dtype=dtype, device=device)
    out, off = {}, 0
    for name, shape, mean, std in spec:
        k = math.prod(shape)
        t = flat[off:off + k].view(shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += k
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
              derived: Tuple[str, ...] = ("weight_scale",)) -> int:
    """Copy ``weights`` into ``model``'s parameters by name. A parameter the
    weights do not name must be one the model derives itself (``derived``:
    the int8 tier's scales, set when the base is quantized). Returns the
    number copied."""
    n = 0
    names = set()
    for name, p in model.named_parameters():
        if name in weights:
            p.copy_(weights[name].to(p.dtype))
            names.add(name)
            n += 1
        elif not name.endswith(derived):
            raise KeyError(f"the benchmark's weights have no {name}")
    missing = set(weights) - names
    if missing:
        raise KeyError(f"the model has no {sorted(missing)[:5]}")
    return n
