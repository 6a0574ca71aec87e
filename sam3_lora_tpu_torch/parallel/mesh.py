"""The ``(data, model)`` layout of the process group's ranks and the
placement helpers (port of ``sam3_lora_tpu/parallel/mesh.py``).

JAX lays its devices out as a 2D mesh and lets XLA insert the collectives
from sharding annotations. Here each rank is a process with one card: the
mesh is the grid of rank numbers, a placement (``Sharding``) names which
tensor axis is split over which mesh axis, and the training step's
collectives are written out (``train/losses.py``, ``train/trainer.py``).

``param_shardings(shard_base=True)`` gives JAX's placement rule for each
parameter in the port's (torch) layout, and ``shard_params_`` places a model
so, as ``jax.device_put`` of those shardings does: each rank keeps only its
slice of every base weight the rule splits, and each module gathers the
whole weight over the rank's data group where it uses it
(``parallel/fsdp.py``). The training step and its one all-reduce of the
adapters' gradients run on it unchanged: the adapters stay replicated and
the base takes no gradient, so nothing is reduce-scattered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from . import fsdp
from .multihost import process_count, process_index

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """Ranks on a ``(data, model)`` grid; ``shape`` maps an axis name to its
    size, as a JAX mesh's does."""

    ranks: np.ndarray  # (data, model) int

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, model index) of ``rank``."""
        d, m = np.argwhere(self.ranks == rank)[0]
        return int(d), int(m)


@dataclass(frozen=True)
class Sharding:
    """A placement: ``spec[i]`` names the mesh axis that tensor axis ``i``
    is split over (None: not split); an empty spec is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """(data, model) grid over the first ``n_devices`` ranks of the group
    (one rank without a group); ``model_parallel`` ranks share a data index,
    the rest are data parallel."""
    rs = list(ranks) if ranks is not None else list(range(process_count()))
    if n_devices is not None:
        rs = rs[:n_devices]
    n = len(rs)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return Mesh(np.asarray(rs).reshape(n // model_parallel, model_parallel))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def shard_batch(batch, mesh: Mesh, rank: Optional[int] = None):
    """This rank's part of a host ``Batch``: its contiguous share of the
    images over the data axis and the rows (prompts) that index them, with
    ``img_ids`` renumbered from 0, as ``train/trainer.py::split_microbatches``
    splits a batch. Rows are not split by position: a row goes with its
    image, so the ranks may hold different numbers of rows. ``rank`` is the
    caller's rank by default."""
    from ..models import Batch
    from ..train.prefetch import map_tensors

    n_data = mesh.shape[DATA_AXIS]
    d = mesh.coords(process_index() if rank is None else rank)[0]
    n_img = batch.images.shape[0]
    if n_img % n_data:
        raise ValueError(f"{n_img} images do not split over {n_data} data ranks")
    per = n_img // n_data
    lo, hi = d * per, (d + 1) * per
    rows = torch.nonzero((batch.img_ids >= lo) & (batch.img_ids < hi)).flatten()

    def take(t):
        return t[rows.to(t.device)]

    return Batch(
        images=batch.images[lo:hi],
        token_ids=take(batch.token_ids),
        img_ids=take(batch.img_ids) - lo,
        geo=map_tensors(batch.geo, take),
        targets=map_tensors(batch.targets, take),
    )


def param_shardings(model: nn.Module, mesh: Mesh, shard_base: bool = False) -> Dict[str, Sharding]:
    """Placement of every parameter, by name. Default: every one replicated.
    ``shard_base=True``: JAX's rule, the largest dim of each base weight
    that divides over the data axis (the lower JAX axis on a tie) split over
    it, adapters and leaves under 2**16 entries or 2 dims replicated,
    applied to the JAX layout and named in the torch one."""
    from ..utils.checkpoint import jax_axes

    rep = replicated(mesh)
    out = {}
    n_data = mesh.shape[DATA_AXIS]
    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = rep
            if not shard_base or leaf in ("lora_a", "lora_b"):
                continue
            axes = jax_axes(module, leaf, p.ndim)
            shape = [p.shape[a] for a in axes]  # the JAX layout
            if len(shape) < 2 or int(np.prod(shape)) < 2**16:
                continue
            for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[ax] % n_data == 0:
                    spec = [None] * p.ndim
                    spec[axes[ax]] = DATA_AXIS
                    out[name] = Sharding(mesh, tuple(spec))
                    break
    return out


def data_groups(mesh: Mesh) -> List[List[int]]:
    """The ranks of each data group, by model index: the ranks that share a
    model index, in data order (the slices of a sharded weight)."""
    return [mesh.ranks[:, m].tolist() for m in range(mesh.ranks.shape[1])]


def shard_params_(model: nn.Module, shardings: Dict[str, Sharding]) -> int:
    """Place ``model`` by ``shardings`` (``param_shardings``' names): every
    parameter split over the data axis keeps only this rank's slice, its
    index the rank's data coordinate, and takes no gradient; its module
    gathers it over the rank's data group at use (``parallel/fsdp.py``).
    Every rank of the process group must call this, in the same order as
    its other collectives: it makes one group per model index
    (``torch.distributed.new_group``). A module that cannot gather the leaf
    raises, before anything changes. Returns the number of parameters
    sharded."""
    split = {name: s for name, s in shardings.items() if DATA_AXIS in s.spec}
    if not split:
        return 0
    mesh = next(iter(split.values())).mesh
    if any(s.mesh is not mesh for s in split.values()):
        raise ValueError("the shardings name more than one mesh")
    n = mesh.shape[DATA_AXIS]
    owners = []
    for name, s in split.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        dim = s.spec.index(DATA_AXIS)
        if leaf not in getattr(owner, "SHARDED_AT_USE", ()):
            raise ValueError(f"{name}: {type(owner).__name__} does not gather {leaf!r} at use")
        if fsdp.shard_of(owner, leaf) is not None:
            raise ValueError(f"{name} is sharded already")
        if getattr(owner, leaf).shape[dim] % n:
            raise ValueError(f"{name}: axis {dim} does not split over {n} ranks")
        owners.append((owner, leaf, dim))
    if not dist.is_initialized():
        raise RuntimeError("shard_params_ needs a process group: the slices are gathered at use")
    groups = [dist.new_group(ranks) for ranks in data_groups(mesh)]
    d, m = mesh.coords(process_index())
    for owner, leaf, dim in owners:
        shard = fsdp.Shard(dim, n, d, groups[m])
        setattr(owner, leaf, nn.Parameter(fsdp.local(shard, getattr(owner, leaf).detach()),
                                          requires_grad=False))
        fsdp.mark(owner, leaf, shard)
    fsdp.install(model)
    return len(owners)
