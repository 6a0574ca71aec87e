"""The ``(data, model)`` layout of the process group's ranks and the
placement helpers (port of ``sam3_lora_tpu/parallel/mesh.py``).

JAX lays its devices out as a 2D mesh and lets XLA insert the collectives
from sharding annotations. Here each rank is a process with one card: the
mesh is the grid of rank numbers, a placement (``Sharding``) names which
tensor axis is split over which mesh axis, and the training step's
collectives are written out (``train/losses.py``, ``train/trainer.py``).

``param_shardings(shard_base=True)`` gives JAX's placement rule for each
parameter in the port's (torch) layout. Executing a sharded base (gathering
each weight at use) is not ported: the JAX ``Trainer`` never asks for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

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
