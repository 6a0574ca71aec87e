from . import multihost
from .dist_utils import (
    all_gather_objects,
    barrier,
    broadcast_object,
    filesystem_gather,
    get_rank,
    get_world_size,
    is_main_process,
)
from .frame_parallel import FrameParallelDetector
from .mesh import (batch_sharding, make_mesh, param_shardings, replicated, shard_batch,
                   shard_params_)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "param_shardings",
    "shard_params_",
    "get_rank",
    "get_world_size",
    "is_main_process",
    "all_gather_objects",
    "broadcast_object",
    "filesystem_gather",
    "barrier",
    "FrameParallelDetector",
    "multihost",
]
