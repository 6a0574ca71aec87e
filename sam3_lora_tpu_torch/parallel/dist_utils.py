"""Host-side distributed utilities (port of ``sam3_lora_tpu/parallel/dist_utils.py``):
the rank and world size, pickled-object gathers and broadcasts, a barrier,
and ``filesystem_gather`` for payloads too large for a collective (the same
file protocol as the JAX package's, a copy).

Everything degrades to the single-process answer when no process group is
initialized, so the same code runs in the tests and across cards.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .multihost import group_ready, process_count, process_index

__all__ = [
    "get_rank",
    "get_world_size",
    "is_main_process",
    "all_gather_objects",
    "broadcast_object",
    "filesystem_gather",
    "barrier",
    "all_reduce_mean_",
    "broadcast_",
]


def get_rank() -> int:
    return process_index()


def get_world_size() -> int:
    return process_count()


def is_main_process() -> bool:
    return get_rank() == 0


def all_gather_objects(data: Any) -> List[Any]:
    """Gather a picklable object from every rank; every rank gets the
    world-size list (``[data]`` for one process)."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


def broadcast_object(data: Any, src: int = 0) -> Any:
    """``data`` of rank ``src`` on every rank."""
    if get_world_size() == 1:
        return data
    box = [data]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier(name: str = "barrier"):
    """A sync point of every rank (``name`` is kept for the JAX signature);
    under NCCL on the rank's own card."""
    del name
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _bucket_op_(tensors: Sequence[torch.Tensor], op) -> None:
    """Run ``op`` on one flat fp32 bucket of ``tensors`` and copy it back
    (exact for fp32, bf16 and fp16 tensors)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    op(flat)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` in place over the process group with one
    ``all_reduce`` of a flat bucket; nothing without a group."""
    if not group_ready() or not tensors:
        return

    def mean(flat):
        dist.all_reduce(flat)
        flat /= dist.get_world_size()

    _bucket_op_(tensors, mean)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in one
    broadcast of a flat bucket; nothing without a group."""
    if group_ready() and tensors:
        _bucket_op_(tensors, lambda flat: dist.broadcast(flat, src=src))


def filesystem_gather(
    data: Any,
    shared_dir: str,
    tag: str = "gather",
    timeout_s: float = 3600.0,
    poll_s: float = 0.5,
    cleanup: bool = True,
) -> Optional[List[Any]]:
    """Gather huge picklable payloads through a shared filesystem: every
    rank writes ``<shared_dir>/<tag>_rank<i>.pkl`` plus a ``.done`` marker;
    rank 0 polls until all markers exist, loads everything, and returns the
    list; other ranks return None."""
    os.makedirs(shared_dir, exist_ok=True)
    rank, world = get_rank(), get_world_size()
    path = os.path.join(shared_dir, f"{tag}_rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(data, f)
    os.replace(path + ".tmp", path)  # atomic publish
    open(path + ".done", "w").close()

    if rank != 0:
        return None
    deadline = time.time() + timeout_s
    paths = [
        os.path.join(shared_dir, f"{tag}_rank{r}.pkl") for r in range(world)
    ]
    while not all(os.path.exists(p + ".done") for p in paths):
        if time.time() > deadline:
            raise TimeoutError(f"filesystem_gather timed out waiting for {tag}")
        time.sleep(poll_s)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(pickle.load(f))
        if cleanup:
            os.remove(p)
            os.remove(p + ".done")
    return out
