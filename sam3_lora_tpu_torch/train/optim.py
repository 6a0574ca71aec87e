"""Parameter-group AdamW with pattern matching and ViT layer decay (port of
``sam3_lora_tpu/train/optim.py``).

Each group is ``{"patterns": [fnmatch...], "lr_scale": f, "weight_decay": f,
"name": str}`` (all but the patterns optional); a parameter takes the first
group one of whose patterns matches it, and two patterns of one group may
not both match it. The rest fall to an implicit default group. With
``layer_decay`` each group is further split by the ViT layer-decay scale
``decay^(num_layers + 1 - layer_id)``.

Patterns match the JAX package's path of each parameter (its Flax path
joined by '/', e.g. ``backbone.vision_backbone.trunk/blocks.3/attn/qkv/
kernel``), which ``jax_path`` rebuilds from the port's name, so a YAML
written for the JAX package selects the same parameters here. The result is
one ``torch.optim.AdamW`` with a param group per label ``name|scale|wd``;
``update(step)`` clips the gradients by their global norm over every group
and steps each group at ``base_lr_schedule(step) * scale``, as
``optax.chain(clip_by_global_norm, multi_transform(adamw...))`` does. As in
optax, every parameter of the optimizer should have a gradient at each step
(torch's AdamW skips a parameter without one; optax's state would advance).
"""

from __future__ import annotations

import fnmatch
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..models.layers import Conv2d, LoRALinear
from .trainer import apply_update

__all__ = [
    "path_str",
    "jax_path",
    "get_vit_layer_id",
    "layer_decay_scales",
    "make_grouped_optimizer",
    "GroupedAdamW",
]


def path_str(path: Tuple[str, ...]) -> str:
    return "/".join(str(p) for p in path)


# JAX module and parameter names that hold a '.', each one path segment; any
# other '.' of a port name separates two segments
_JAX_SEGMENT = re.compile("|".join((
    r"backbone\.vision_backbone\.trunk",
    r"backbone\.(?:vision|language)_backbone",
    r"transformer\.resblocks\.\d+",
    r"transformer\.(?:encoder|decoder)",
    r"convs\.\d+\.\w+",
    r"mask_predictor\.mask_embed",
    r"mlp\.c_(?:fc|proj)",
    r"(?<=patch_embed\.)proj\.kernel",
    r"fuser\.layers\.\d+",
    r"pe_layer\.positional_encoding_gaussian_matrix",
    r"\w+\.\d+",
)))


def jax_path(model: nn.Module, name: str) -> str:
    """The JAX package's '/'-joined path of the port's parameter ``name``:
    a linear's or conv's ``weight`` is its ``kernel`` (``weight_scale`` its
    ``kernel_scale``), and the segments are the JAX module names."""
    owner, _, leaf = name.rpartition(".")
    if isinstance(model.get_submodule(owner), (LoRALinear, Conv2d)):
        leaf = {"weight": "kernel", "weight_scale": "kernel_scale"}.get(leaf, leaf)
    full = f"{owner}.{leaf}" if owner else leaf
    parts, i = [], 0
    while i < len(full):
        m = _JAX_SEGMENT.match(full, i)
        if m and (m.end() == len(full) or full[m.end()] == "."):
            end = m.end()
        else:
            dot = full.find(".", i)
            end = len(full) if dot < 0 else dot
        parts.append(full[i:end])
        i = end + 1
    return "/".join(parts)


# --- ViT layer-wise lr decay ------------------------------------------------


_SCAN_RE = re.compile(r"scan_blocks_(\d+)")
_BLOCK_RE = re.compile(r"blocks?[_./](\d+)")


def get_vit_layer_id(path: str, num_layers: int, cfg=None) -> int:
    """Layer index for decay: patch embed / pos embed -> 0, block i -> i+1,
    everything else (neck, downstream) -> num_layers + 1 (no decay). The
    JAX package's scanned layout (``scan_blocks_{g}``, the stacked run of
    windowed blocks before global block g) takes the decay of the run's
    middle block; the port has no such layout, but a pattern file may name
    it."""
    if "patch_embed" in path or "pos_embed" in path:
        return 0
    m = _SCAN_RE.search(path)
    if m:
        g = int(m.group(1))
        globals_ = sorted(cfg.vit_global_blocks) if cfg else [7, 15, 23, 31]
        start = 0 if g == 0 else globals_[g - 1] + 1
        end = globals_[g] - 1  # last windowed block of the run
        return (start + end) // 2 + 1
    m = _BLOCK_RE.search(path)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def layer_decay_scales(paths: Iterable[str], decay: float, num_layers: int = 32,
                       vit_prefix: str = "trunk", cfg=None) -> Dict[str, float]:
    """Per-path lr multiplier ``decay^(num_layers + 1 - layer_id)`` for ViT
    parameters, 1.0 elsewhere."""
    return {p: decay ** (num_layers + 1 - get_vit_layer_id(p, num_layers, cfg))
            if vit_prefix in p else 1.0 for p in paths}


# --- grouped optimizer ------------------------------------------------------


def _match_group(path: str, groups: Sequence[Dict]) -> Optional[int]:
    for gi, g in enumerate(groups):
        hits = [pat for pat in g["patterns"] if fnmatch.fnmatch(path, pat)]
        if len(hits) > 1:
            raise ValueError(
                f"param '{path}' matched {len(hits)} patterns in group {gi}: {hits}"
                " (reference requires non-overlapping coverage)"
            )
        if hits:
            return gi
    return None


class GroupedAdamW(torch.optim.AdamW):
    """AdamW whose param groups carry an ``lr_scale``; ``update(step)`` is
    one optax update of the grouped transform."""

    def __init__(self, param_groups: List[Dict], base_lr_schedule: Callable[[int], float],
                 max_grad_norm: Optional[float], **kwargs):
        super().__init__(param_groups, lr=0.0, **kwargs)
        self.base_lr_schedule = base_lr_schedule
        self.max_grad_norm = max_grad_norm

    def update(self, step: int) -> None:
        """Clip over every group, step at ``base_lr_schedule(step)`` times
        each group's scale, clear the gradients."""
        params = [p for g in self.param_groups for p in g["params"]]
        apply_update(self, params, self.base_lr_schedule(step), self.max_grad_norm)


def make_grouped_optimizer(
    model: nn.Module,
    base_lr_schedule: Callable[[int], float],
    groups: Optional[Sequence[Dict]] = None,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    layer_decay: Optional[float] = None,
    num_vit_layers: int = 32,
    model_cfg=None,
    params: Optional[Iterable[Tuple[str, nn.Parameter]]] = None,
) -> Tuple[GroupedAdamW, Dict[str, str]]:
    """AdamW whose lr and weight decay vary per group, over ``params``
    ((name, parameter) pairs of ``model``; default: those that need a
    gradient). Returns (optimizer, labels: the port's name -> its label)."""
    groups = list(groups or [])
    named = list(params if params is not None else
                 ((n, p) for n, p in model.named_parameters() if p.requires_grad))
    paths = {n: jax_path(model, n) for n, _ in named}
    ld_scales = (layer_decay_scales(paths.values(), layer_decay, num_vit_layers, cfg=model_cfg)
                 if layer_decay is not None else {p: 1.0 for p in paths.values()})
    labels: Dict[str, str] = {}
    param_groups: Dict[str, Dict] = {}
    for n, p in named:
        path = paths[n]
        gi = _match_group(path, groups)
        if gi is None:
            lr_scale, wd, gname = 1.0, weight_decay, "default"
        else:
            lr_scale = float(groups[gi].get("lr_scale", 1.0))
            wd = float(groups[gi].get("weight_decay", weight_decay))
            gname = groups[gi].get("name", f"group{gi}")
        s = lr_scale * ld_scales[path]
        label = f"{gname}|{s:.6g}|{wd:.6g}"
        labels[n] = label
        param_groups.setdefault(label, {"params": [], "lr_scale": s, "weight_decay": wd,
                                        "label": label})["params"].append(p)
    opt = GroupedAdamW(list(param_groups.values()), base_lr_schedule, max_grad_norm,
                       betas=(b1, b2), eps=eps)
    return opt, labels
