"""Logging and meters (port of ``sam3_lora_tpu/utils/logging.py``).

``setup_logging``, the meters and ``TensorBoardLogger`` keep the JAX
package's names, messages and JSON-lines fallback. The device parts read
PyTorch: ``MemMeter`` the CUDA caching allocator's counters (0 on the CPU),
``trace_span`` a ``torch.profiler.record_function`` range (plus an NVTX
range on the card) and ``capture_trace`` a ``torch.profiler`` trace into a
directory, where JAX read ``device.memory_stats()`` and wrote XPlane traces.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional

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


class trace_span:
    """A named range in ``torch.profiler`` traces (``record_function``) and,
    on a machine with a card, in NVTX; costs a few microseconds when no
    profiler runs."""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None
        self._nvtx = False

    def __enter__(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return self._ctx.__exit__(*exc)


def capture_trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the enclosed steps (the
    CPU, and the card when there is one), written as a Chrome trace JSON into
    ``log_dir`` (open it in ui.perfetto.dev or TensorBoard's profiler)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    return [tree]


def shape_logging_wrapper(fn, name: str = None, logger=None):
    """Log each novel combination of input shapes and dtypes that the
    wrapped callable sees (every leaf of its arguments: tensors, arrays, and
    other values as shape ``()``), the message the JAX package prints."""
    seen = set()
    label = name or getattr(fn, "__name__", "fn")
    out = logger.info if logger else print

    def describe(tree):
        return tuple(
            (tuple(getattr(leaf, "shape", ())), str(getattr(leaf, "dtype", type(leaf))))
            for leaf in _leaves(tree)
        )

    def wrapped(*args, **kwargs):
        sig = (describe(args), describe(kwargs))
        if sig not in seen:
            seen.add(sig)
            shapes = [s for s, _ in sig[0]]
            out(f"[shapes] {label}: novel input combo #{len(seen)}: {shapes}")
        return fn(*args, **kwargs)

    wrapped.seen_shapes = seen
    return wrapped
