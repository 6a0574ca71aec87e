"""Multi-process launch support (port of ``sam3_lora_tpu/parallel/multihost.py``).

JAX runs one process per host, and every process sees the global devices
through one mesh. Here it is one process per card, as ``torch.distributed``
has it: each rank holds the adapters, its own shard of the batch, and joins
the others through collectives (NCCL between cards, gloo on the CPU).

Usage (the same script on every rank; ``torch.distributed.run`` sets the
environment)::

    from sam3_lora_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op for one process
    loader = DataLoader(ds, per_rank_batch, host_shard=multihost.host_shard())
    batch = multihost.globalize(local_batch, mesh)   # to this rank's card
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def group_ready() -> bool:
    """True when this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join a ``torch.distributed`` process group. Returns True iff one was
    joined (or one was already there).

    The arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``coordinator_address`` is ``host:port``),
    ``WORLD_SIZE`` and ``RANK``. With one process and no address in the
    environment it is a no-op and returns False, as JAX's is. The backend is
    NCCL when a card is present and gloo otherwise, unless ``backend`` names
    one; NCCL without a card raises. Under NCCL the rank's card is set to
    ``cuda:LOCAL_RANK``.
    """
    if group_ready():
        return True
    env = os.environ
    num = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num <= 1 and addr is None:
        return False
    if addr is None:
        raise ValueError(f"{num} processes need a coordinator address (host:port or MASTER_ADDR)")
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; pass backend='gloo' for the CPU")
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if group_ready():
        dist.destroy_process_group()


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``; the rank
    itself when the variable is unset)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device(name: str = "cuda") -> torch.device:
    """``name`` resolved to this rank's device: ``cuda`` is
    ``cuda:LOCAL_RANK``; anything else as it is."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def process_index() -> int:
    return dist.get_rank() if group_ready() else 0


def process_count() -> int:
    return dist.get_world_size() if group_ready() else 1


def is_primary() -> bool:
    """Rank-0 guard for checkpoint and stats writes."""
    return process_index() == 0


@dataclass(frozen=True)
class HostShard:
    """Which slice of the dataset this rank owns (DistributedSampler
    semantics: contiguous stride partition)."""

    index: int
    count: int

    def indices(self, n: int) -> np.ndarray:
        """Rank's strided subset of ``range(n)`` (drop-last across ranks)."""
        per = n // self.count
        return np.arange(n)[self.index * per : (self.index + 1) * per]


def host_shard() -> HostShard:
    return HostShard(process_index(), process_count())


def globalize(local_batch: Any, mesh=None, device: str = "cuda") -> Any:
    """This rank's batch, on this rank's card.

    In JAX this assembles the hosts' batches into one global array sharded
    over the mesh. With one process per card no rank holds the global batch:
    each keeps its own shard, and the training step's collectives (the loss
    denominators and the gradient all-reduce) make the update the global
    batch's. So here it moves the local batch to ``device`` (the rank's card
    unless the caller names another) and nothing else; ``mesh`` is accepted
    for the JAX signature."""
    from ..train.prefetch import batch_to_device

    del mesh
    return batch_to_device(local_batch, rank_device(device))
