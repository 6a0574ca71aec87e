"""Frame-parallel video detection over the data ranks (port of
``sam3_lora_tpu/parallel/frame_parallel.py``).

Frames are a batch dimension. A chunk of frames is split over the mesh's
data axis: each rank runs its part of the chunk as one batch through the
detector, the outputs are all-gathered, and every rank yields every frame in
order. The next chunk's host-to-device copy is dispatched on a side stream
from pinned memory while the current chunk computes, as
``train/prefetch.py`` does for training batches. With one rank the whole
chunk is one batch on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from .mesh import DATA_AXIS, make_mesh
from .multihost import group_ready, process_index, rank_device

__all__ = ["FrameParallelDetector"]


class FrameParallelDetector:
    """Runs a batch-first detection function over chunks of frames split
    across the mesh's data ranks, with double-buffered host-to-device copies.

    ``detect_fn(model, images, token_ids)`` returns a tensor, or a dict,
    tuple or list of tensors, each batch-first: ``SAM3LoRAInference._forward``
    with the engine as ``model``, or any function of that shape. Frames go
    to ``device`` (this rank's card unless the caller asks for the CPU).
    """

    def __init__(
        self,
        detect_fn: Callable,
        model: Any,
        mesh=None,
        chunk_size: Optional[int] = None,
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_data = self.mesh.shape[DATA_AXIS]
        self.chunk = chunk_size if chunk_size is not None else int(n_data)
        if self.chunk % n_data != 0:
            raise ValueError(
                f"chunk_size {self.chunk} must be divisible by the data axis ({n_data} devices)"
            )
        self.model = model
        self.fn = detect_fn
        self.device = rank_device(device)
        self.n_data = n_data
        self.data_index = self.mesh.coords(process_index())[0]
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _put(self, images: np.ndarray, token_ids: np.ndarray):
        """This rank's part of a chunk on the device; on the card the copy is
        issued on the side stream, and the compute stream waits for it."""
        per = images.shape[0] // self.n_data
        part = slice(self.data_index * per, (self.data_index + 1) * per)
        host = (torch.from_numpy(np.ascontiguousarray(images[part])),
                torch.from_numpy(np.ascontiguousarray(token_ids[part])))
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            moved = tuple(t.pin_memory().to(self.device, non_blocking=True) for t in host)
            done = torch.cuda.Event()
            done.record(self._stream)
        return moved, done

    def _take(self, put):
        moved, done = put
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in moved:  # allocated on the side stream, used on this one
                t.record_stream(current)
        return moved

    def _gather(self, out):
        """The whole chunk's outputs from every data rank's part, on the host."""
        if not group_ready() or dist.get_world_size() == 1:
            return tree_map(lambda t: t.detach().cpu().numpy(), out)
        world = dist.get_world_size()
        firsts = [int(self.mesh.ranks[d, 0]) for d in range(self.n_data)]

        def gather(t):
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t)
            return torch.cat([parts[r] for r in firsts]).cpu().numpy()

        return tree_map(gather, out)

    def detect_video(
        self,
        frames: Sequence[np.ndarray],     # F x (3, R, R) preprocessed
        token_ids: np.ndarray,            # (L,) one prompt for the video
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield per-frame outputs (numpy) in order. The next chunk's copy is
        dispatched before the current chunk's results are fetched."""
        f = len(frames)
        w = self.chunk
        n_chunks = (f + w - 1) // w

        def chunk_arrays(ci: int):
            lo = ci * w
            hi = min(lo + w, f)
            imgs = np.stack(list(frames[lo:hi]))
            pad = w - imgs.shape[0]
            if pad:  # static chunk shape; padded frames are dropped on yield
                imgs = np.concatenate(
                    [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)]
                )
            return imgs, np.array(np.broadcast_to(token_ids, (w,) + token_ids.shape))

        put_next = self._put(*chunk_arrays(0))
        for ci in range(n_chunks):
            out = self.fn(self.model, *self._take(put_next))
            if ci + 1 < n_chunks:  # prefetch while the chunk computes
                put_next = self._put(*chunk_arrays(ci + 1))
            host = self._gather(out)
            for i in range(min(w, f - ci * w)):
                yield tree_map(lambda x: x[i], host)
