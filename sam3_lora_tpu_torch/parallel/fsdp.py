"""A sharded frozen base, gathered at use: what XLA inserts for the JAX
package's ``param_shardings(..., shard_base=True)`` placement (an all-gather
before each use of a sharded weight), written out for ``torch.distributed``.

``mesh.shard_params_`` leaves each rank its slice of every base parameter
whose placement names the data axis, and records a ``Shard`` on the module
that owns it. That module asks for the whole tensor where it uses it,
``full(module, leaf, dtype)``: the slices of the rank's data group are
gathered and laid end to end along the split axis. Only the leaves a module
lists in its ``SHARDED_AT_USE`` may be sharded, since only those are read
through ``full``.

A gathered weight lives only while it is used; the backward gathers it
again. Autograd would otherwise keep it in three ways:

* an operator saves it (``F.linear``, the convolutions). While the sharded
  model's forward runs, saved-tensor hooks pack a gathered tensor, or a view
  of it, as a ``Regather`` (its owner, leaf, dtype and view), and the
  backward's unpack gathers it again;
* inside a checkpoint region the region's own hooks are the innermost: they
  drop it, and the region's replay in the backward gathers it again;
* an ``autograd.Function`` holds it on ``ctx`` (the int8 products of
  ``ops/quant.py``). It holds ``pack(w)`` instead and reads ``unpack(...)``
  in its backward.

The gathers of the backward are collectives too. Every rank of a data group
runs the same graph, so it gathers the same weights in the same order,
replays included.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

# gathers since the last reset, in the forward and in the backward (a
# checkpoint replay and a Regather's unpack are both in the backward)
GATHERS = {"forward": 0, "backward": 0}

# storage address of each live gathered tensor -> (weak reference to it,
# owner, leaf, dtype asked for)
_LIVE: Dict[int, Tuple[weakref.ref, nn.Module, str, Optional[torch.dtype]]] = {}


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's slice of one parameter: slice ``index`` of ``count`` equal
    ones along torch axis ``dim``, the others held by the ranks of
    ``group``, in order."""

    dim: int
    count: int
    index: int
    group: Any  # torch.distributed.ProcessGroup


def shard_of(module: nn.Module, leaf: str) -> Optional[Shard]:
    return module.__dict__.get("_shards", {}).get(leaf)


def mark(module: nn.Module, leaf: str, shard: Shard) -> None:
    """Record that ``module.<leaf>`` holds only ``shard``."""
    module.__dict__.setdefault("_shards", {})[leaf] = shard


def local(shard: Shard, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole tensor ``t``, in its own storage."""
    if t.shape[shard.dim] % shard.count:
        raise ValueError(f"axis {shard.dim} of {tuple(t.shape)} does not split "
                         f"over {shard.count} ranks")
    return t.chunk(shard.count, shard.dim)[shard.index].clone()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def full(module: nn.Module, leaf: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``module.<leaf>`` whole, in ``dtype`` (its own by default): the
    parameter itself (cast) when it is not sharded, else the slices of its
    data group gathered. A gather that fails raises."""
    p = getattr(module, leaf)
    shard = shard_of(module, leaf)
    if shard is None:
        return p if dtype is None else p.to(dtype)
    if p.requires_grad:
        raise RuntimeError(f"{type(module).__name__}.{leaf} is sharded and takes no gradient")
    part = p.detach() if dtype is None else p.detach().to(dtype)  # elementwise: cast, then move
    parts = [torch.empty_like(part) for _ in range(shard.count)]
    dist.all_gather(parts, part.contiguous(), group=shard.group)
    t = torch.cat(parts, dim=shard.dim)
    GATHERS["backward" if _in_backward() else "forward"] += 1
    key = t.untyped_storage().data_ptr()

    def forget(ref, key=key):
        if _LIVE.get(key, (None,))[0] is ref:
            del _LIVE[key]

    _LIVE[key] = (weakref.ref(t, forget), module, leaf, dtype)
    return t


def live_gathered() -> int:
    """How many gathered tensors are alive (autograd keeps a tensor it saves
    alive, so this counts the ones it holds)."""
    return sum(ref() is not None for ref, *_ in _LIVE.values())


@dataclasses.dataclass(frozen=True)
class Regather:
    """A saved gathered tensor, as the recipe to gather it again: the owner's
    leaf in ``dtype``, then the saved view (shape, strides, offset)."""

    module: nn.Module
    leaf: str
    dtype: Optional[torch.dtype]
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int

    def materialize(self) -> torch.Tensor:
        return full(self.module, self.leaf, self.dtype).as_strided(self.size, self.stride,
                                                                   self.offset)


def pack(t):
    """A gathered tensor (or a view of one) -> its ``Regather``; any other
    tensor as it is."""
    if t.layout != torch.strided:
        return t
    entry = _LIVE.get(t.untyped_storage().data_ptr())
    base = entry[0]() if entry is not None else None
    if base is None or base.dtype != t.dtype:
        return t
    return Regather(entry[1], entry[2], entry[3], tuple(t.shape), t.stride(), t.storage_offset())


def unpack(x):
    return x.materialize() if isinstance(x, Regather) else x


def install(model: nn.Module) -> None:
    """Pack gathered tensors while ``model``'s forward runs (once a model)."""
    if model.__dict__.get("_gather_hooks_installed"):
        return
    open_hooks = []

    def enter(_module, _args):
        hooks = torch.autograd.graph.saved_tensors_hooks(pack, unpack)
        hooks.__enter__()
        open_hooks.append(hooks)

    def leave(_module, _args, _out):
        open_hooks.pop().__exit__(None, None, None)

    model.register_forward_pre_hook(enter)
    model.register_forward_hook(leave, always_call=True)
    model.__dict__["_gather_hooks_installed"] = True
