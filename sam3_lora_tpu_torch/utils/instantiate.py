"""Config-tree dependency injection (the Hydra/OmegaConf tier): the port's own
copy of ``sam3_lora_tpu/utils/instantiate.py``, which imports no JAX.

The reference has two config tiers (SURVEY.md §5): the LoRA-native plain
YAML (`configs/*.yaml` — preserved verbatim by ``config.load_yaml_config``)
and the official Hydra DI trees whose nodes carry ``_target_`` classpaths
and ``${...}`` interpolations (``sam3_lora_configs/lora_base.yaml:99-430``,
``sam3/train/configs/**``). This module provides the second tier without
the hydra dependency:

* :func:`resolve` — ``${a.b.c}`` interpolation against the config root
  (OmegaConf-style), including interpolations inside strings.
* :func:`instantiate` — recursively constructs the object graph from
  ``_target_`` nodes, with ``_partial_: true`` -> functools.partial
  (hydra.utils.instantiate semantics used by trainer.py:1060-1103).

Kept deliberately small: the subset the reference's configs actually use.
"""

from __future__ import annotations

import functools
import importlib
import re
from typing import Any, Dict, List, Union

__all__ = ["resolve", "instantiate", "locate"]

_INTERP = re.compile(r"\$\{([^}]+)\}")


def locate(path: str) -> Any:
    """'pkg.mod.Class' -> the Class object (hydra.utils.get_class/locate)."""
    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        try:
            for name in parts[i:]:
                obj = getattr(obj, name)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"cannot locate {path!r}")


def _lookup(root: Any, dotted: str) -> Any:
    cur = root
    for part in dotted.split("."):
        if isinstance(cur, dict):
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            cur = getattr(cur, part)
    return cur


def resolve(node: Any, root: Any = None, _depth: int = 0) -> Any:
    """Resolve ``${path}`` interpolations recursively. A string that is
    exactly one interpolation keeps the referenced value's type; embedded
    interpolations stringify (OmegaConf behaviour)."""
    if _depth > 32:
        raise RecursionError("interpolation cycle")
    if root is None:
        root = node
    if isinstance(node, dict):
        return {k: resolve(v, root, _depth + 1) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve(v, root, _depth + 1) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:
            return resolve(_lookup(root, m.group(1)), root, _depth + 1)
        return _INTERP.sub(
            lambda mm: str(resolve(_lookup(root, mm.group(1)), root, _depth + 1)),
            node,
        )
    return node


def instantiate(cfg: Any, _root_resolved: bool = False, **overrides) -> Any:
    """Build the object graph: dicts with ``_target_`` become constructor
    calls (children instantiated first); ``_partial_: true`` returns a
    functools.partial instead of calling. Non-target nodes pass through
    with their children instantiated."""
    if not _root_resolved:
        cfg = resolve(cfg)
    if isinstance(cfg, list):
        return [instantiate(v, _root_resolved=True) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    kids = {
        k: instantiate(v, _root_resolved=True)
        for k, v in cfg.items()
        if k not in ("_target_", "_partial_")
    }
    kids.update(overrides)
    if "_target_" in cfg:
        target = locate(cfg["_target_"])
        if cfg.get("_partial_", False):
            return functools.partial(target, **kids)
        return target(**kids)
    return kids
