"""Logging and meters (port of ``sam3_lora_tpu/utils/logging.py``).

``setup_logging``, the meters and ``TensorBoardLogger`` keep the JAX
package's names, messages and JSON-lines fallback. The device parts read
PyTorch: ``MemMeter`` the CUDA caching allocator's counters (0 on the CPU),
``trace_span`` a ``torch.profiler.record_function`` range (plus an NVTX
range on the card) and ``capture_trace`` a ``torch.profiler`` trace into a
directory, where JAX read ``device.memory_stats()`` and wrote XPlane traces.

The program's own tracing (no JAX counterpart): its spans are named
``sam3.<stage>``; ``count`` / ``counters`` keep its counters, and
``to_host`` / ``to_device`` are its blocking transfers, each in a span
``sam3.sync.<site>`` and counted. While a profiler runs, the spans and the
counters' increments are also recorded (``recorded``) on the profiler's
clock, for a reader in the same process.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch


def setup_logging(
    output_dir: Optional[str] = None,
    level: int = logging.INFO,
    name: str = "sam3_lora_tpu_torch",
) -> logging.Logger:
    """Log to stdout and, with ``output_dir``, to ``<output_dir>/train.log``."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class AverageMeter:
    """Running average."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class DurationMeter:
    def __init__(self):
        self.t0 = time.time()

    def reset(self):
        self.t0 = time.time()

    @property
    def elapsed(self) -> float:
        return time.time() - self.t0


class MemMeter:
    """Peak device memory: the CUDA caching allocator's
    ``max_memory_allocated`` of ``device`` (the current card by default,
    when there is one); 0 on the CPU, which keeps no such counter."""

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.reset()

    def _stats(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return {"bytes_in_use": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device)}

    def reset(self):
        self.start_bytes = self._stats().get("bytes_in_use", 0)
        self.peak = 0

    def update(self):
        s = self._stats()
        peak = s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))
        self.peak = max(self.peak, peak)

    @property
    def peak_gb(self) -> float:
        self.update()
        return self.peak / 2**30


class ProgressMeter:
    """Batch-progress line."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        n = len(str(num_batches))
        self.fmt = "{:" + str(n) + "d}/" + str(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int, logger=None):
        parts = [self.prefix + self.fmt.format(batch)]
        for m in self.meters:
            if isinstance(m, AverageMeter):
                parts.append(f"{m.name} {m.avg:.4f}")
            elif isinstance(m, MemMeter):
                parts.append(f"mem {m.peak_gb:.2f}GB")
            elif isinstance(m, DurationMeter):
                parts.append(f"t {m.elapsed:.1f}s")
        msg = "  ".join(parts)
        (logger.info if logger else print)(msg)
        return msg


class TensorBoardLogger:
    """Scalars to TensorBoard event files through torch's ``SummaryWriter``
    when the ``tensorboard`` package imports, else one JSON line a scalar in
    ``<log_dir>/scalars.jsonl``, so training never needs the package."""

    def __init__(self, log_dir: str, flush_secs: int = 30):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir, flush_secs=flush_secs)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def log(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)})
                              + "\n")

    def log_dict(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            try:
                self.log(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self):
        if self._writer is not None:
            self._writer.flush()
        elif self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
        elif self._jsonl is not None:
            self._jsonl.close()


SPAN_PREFIX = "sam3."  # the program's spans: sam3.<stage>, sam3.sync.<site>

_COUNTERS: Dict[str, int] = {}
# what the program did while a profiler ran, for a reader in this process:
# the spans closed, (name, start ns, end ns), and the counters' increments,
# (name, ns, n), on ``time.time_ns``, the clock of the profiler's events
_RECORD_MAX = 1 << 18
_SPANS: collections.deque = collections.deque(maxlen=_RECORD_MAX)
_COUNTS: collections.deque = collections.deque(maxlen=_RECORD_MAX)
# An NVTX range reaches a tool only when one is injected (Nsight Systems sets
# NVTX_INJECTION64_PATH in the process it launches); without one the two
# calls go nowhere and cost more than the rest of the span
_NVTX = bool(os.environ.get("NVTX_INJECTION64_PATH")) and torch.backends.cuda.is_built()


class trace_span:
    """A named range in ``torch.profiler`` traces (``record_function``, only
    while a profiler runs) and, under an NVTX tool such as ``nsys``, in
    NVTX. Without either it costs about a microsecond; under a profiler the
    span is also recorded (``recorded``), its own cost included."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._t0 = time.time_ns()
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            _SPANS.append((self.name, self._t0, time.time_ns()))
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name`` (always on)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    if torch.autograd._profiler_enabled():
        _COUNTS.append((name, time.time_ns(), n))


def counters() -> Dict[str, int]:
    """A copy of the program's counters: ``host_syncs`` (blocking reads and
    uploads through ``to_host`` / ``to_device``) and ``d2h_bytes``."""
    return dict(_COUNTERS)


def recorded() -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """The spans (name, start ns, end ns) closed and the counter increments
    (name, ns, n) made while a profiler ran, oldest first (the latest
    2**18 of each)."""
    return list(_SPANS), list(_COUNTS)


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``, a blocking read: in span ``sam3.sync.<site>``, counted in
    ``host_syncs`` and its bytes in ``d2h_bytes``. An empty tensor copies
    nothing and waits for nothing: neither spanned nor counted."""
    if t.numel() == 0:
        return t.cpu()
    with trace_span(SPAN_PREFIX + "sync." + site):
        count("host_syncs")
        count("d2h_bytes", t.nelement() * t.element_size())
        return t.cpu()


def to_device(x: torch.Tensor, device, site: str) -> torch.Tensor:
    """``x.to(device)``, a blocking upload (from pageable memory it waits for
    the stream): in span ``sam3.sync.<site>``, counted in ``host_syncs``;
    an empty tensor neither spanned nor counted."""
    if x.numel() == 0:
        return x.to(device)
    with trace_span(SPAN_PREFIX + "sync." + site):
        count("host_syncs")
        return x.to(device)


def capture_trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the enclosed steps (the
    CPU, and the card when there is one), written as a Chrome trace JSON into
    ``log_dir`` (open it in ui.perfetto.dev or TensorBoard's profiler)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
