"""CUDA graphs of the serving forward: each unit captured once per input
shape, then replayed with one launch.

The serving forward has fixed shapes and reads no tensor value on the host,
so its few thousand kernel launches (the hand-written kernels among them,
each as it runs eagerly) can be captured in a ``torch.cuda.CUDAGraph`` and
replayed. ``GraphCache`` holds one model's graphs. A caller hands it a unit
(a function of tensors that returns tensors) and its inputs; the cache
keys the unit by its name, the shape, dtype and device of every input, the
caller's ``tag`` and the kernel routing flags (``ops.routes()``). The first
call of a key runs the unit eagerly once on a side stream, then captures it
(counted on the program's counters ``graph_captures`` and
``graph_captures.<unit>``); every call then copies its inputs into the
graph's static inputs and replays (``graph_replays``). All graphs of a
cache share one memory pool. The cache keeps the ``MAX_GRAPHS`` keys used
last and frees the graph of an older one (a caller with many prompt counts
pays a capture when an evicted count comes back).

A unit engages the cache only where the inputs show that it may
(``GraphCache.engages``): CUDA tensors, gradients disabled, the model in
eval mode and no sharded leaf (``parallel/fsdp.py``); the caller adds
what else it knows (no training targets). Everywhere else it runs eagerly,
as it does without this module: on the CPU, under autograd, in training,
on the meta device, with a sharded base.

A captured graph reads the parameters by address, so an in-place update
(``load_tensors`` copies into them: ``load_adapters``) reaches it. A change
of which tensors the model holds (an adapter set to None, a weight replaced
by its int8 form, a leaf sharded) is seen on the next call and drops the
graphs (``_Fingerprint``); a routing flag is part of every key.

Outputs: ``run`` returns copies of the graph's static outputs (one device
copy each), so nothing a caller keeps aliases the pool, which every replay
of the cache writes.

Launch counters (``entry.launches``, ``ops/``) count the wrappers' calls
alone: a capture runs the unit through them twice (the warm-up and the
capture), a replay launches its kernels from the graph and through none.
"""

from __future__ import annotations

import collections
import operator
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn

from .ops import routes
from .utils.logging import count

MAX_GRAPHS = 8


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


class _Fingerprint:
    """Which tensors the model's modules hold, by identity: a parameter or
    buffer set, replaced or set to None changes it."""

    def __init__(self, model: nn.Module):
        self.dicts = [d for m in model.modules() for d in (m._parameters, m._buffers)]
        self.mods = list(model.modules())
        self.held = self._now()

    def _now(self) -> List:
        return [v for d in self.dicts for v in d.values()]

    def changed(self) -> bool:
        now = self._now()
        if len(now) == len(self.held) and all(map(operator.is_, now, self.held)):
            return False
        self.held = now
        return True

    def sharded(self) -> bool:
        return any(m.__dict__.get("_shards") for m in self.mods)


class _Graph:
    """One captured unit: its static inputs, graph and static outputs."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], pool):
        self.inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs]
        stream = torch.cuda.current_stream(self.inputs[0].device)
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):  # lazy set-up (builds, tables) outside the capture
            fn(*self.inputs)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = list(fn(*self.inputs))

    def replay(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        count("graph_replays")
        return self.outputs


class GraphCache:
    """The captured units of one model (see the module's docstring)."""

    def __init__(self, model: nn.Module):
        self.model = model
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._fingerprint: Optional[_Fingerprint] = None
        self._sharded = False

    def drop(self) -> None:
        """Forget every graph (the next call of each key captures anew)."""
        self._graphs.clear()
        self._pool = None

    def engages(self, *tensors: torch.Tensor) -> bool:
        """Whether a unit on ``tensors`` runs from a graph: all on CUDA,
        gradients disabled, the model in eval mode, no sharded leaf."""
        if (torch.is_grad_enabled() or self.model.training
                or not all(_on_card(t) for t in tensors)):
            return False
        if self._fingerprint is None:
            self._fingerprint = _Fingerprint(self.model)
            self._sharded = self._fingerprint.sharded()
        elif self._fingerprint.changed():
            self.drop()
            self._sharded = self._fingerprint.sharded()
        return not self._sharded

    def run(self, unit: str, fn: Callable, inputs: Sequence[torch.Tensor],
            tag=None) -> List[torch.Tensor]:
        """``fn(*inputs)`` (a sequence of tensors) from the graph of this
        key, captured on its first call: copies of its outputs."""
        key = (unit, tag, routes()) + tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        graph = self._graphs.get(key)
        if graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)
            graph = self._graphs[key] = _Graph(fn, inputs, self._pool)
            count("graph_captures")
            count("graph_captures." + unit)
        else:
            self._graphs.move_to_end(key)
        return [t.clone() for t in graph.replay(inputs)]
