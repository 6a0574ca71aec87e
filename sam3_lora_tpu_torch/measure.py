"""What the port's kernel measurements share: timing, roofline bounds, the
tolerances of a kernel against its plain version, and a profile of one
training step by kernel.

``chip_smoke.py`` and the window-kernel probes (``sam3_lora_tpu_torch/probes``)
both take them from here. Nothing here touches a device at import.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Tuple

import torch

# NVIDIA H100 SXM dense peaks and memory rate (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
MEM_RATE = 3.35e12

# max |kernel - plain| <= KERNEL_RTOL * max |plain|. Both round an fp32 result
# to bf16 and may land one ulp apart, at most 2**-7 of max |plain|; the
# kernel's bf16 P adds less. About 2.5 ulps at the largest output. On an
# H100 (700 W) the forward errors were 0.22x (K1), 0.24x (K2) and 0.19x (K3)
# of the bound; a copy of the kernel that skipped its second K/V tile erred
# by 27x, 13x and 14x of it.
KERNEL_RTOL = 2e-2
# The backward's gradients: max |kernel - plain| <= KERNEL_BWD_RTOL * max
# |plain| per gradient; the kernel also rounds P and dS to bf16 before their
# products. Measured on an H100 (700 W) at 0.16x-0.38x of 2e-2 (at most one
# bf16 ulp of the largest gradient); a copy of the kernel that skipped the
# second query tile of its dK/dV pass erred by 15x-43x of 2e-2 on dK and dV.
KERNEL_BWD_RTOL = 1.5e-2


def timed(fn: Callable, reps: int = 20, device: str = "cuda", warmup: bool = True):
    """(median ms of ``reps`` calls of ``fn()``, the last call's result),
    after one warm-up call: CUDA events on the card, the host clock on the
    CPU."""
    out = None
    if warmup:
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if device == "cpu":
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def median_ms(fn: Callable, reps: int = 20, device: str = "cuda", warmup: bool = True) -> float:
    """The median ms of ``timed``."""
    return timed(fn, reps, device, warmup)[0]


def paired_ms(fa: Callable, fb: Callable, reps: int = 20, device: str = "cuda") -> Tuple[float, float]:
    """The median ms of ``fa()`` and of ``fb()`` timed in turns (a, b, a,
    b, ...) after one warm-up call of each, so that a drift of the card's
    clocks or of the host during the runs reaches both alike."""
    fa()
    fb()
    if device != "cpu":
        torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(reps):
        ta.append(timed(fa, 1, device, warmup=False)[0])
        tb.append(timed(fb, 1, device, warmup=False)[0])
    return statistics.median(ta), statistics.median(tb)


def roofline(t_ops: float, nbytes: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of the seconds the operations take at
    the card's peak for their type and the bytes over its memory rate."""
    t_bytes = nbytes / MEM_RATE
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def attention_work(heads: int, l: int, head_dim: int, backward: bool):
    """(operations, bytes) of one attention call over ``heads`` (batch x
    head) sequences of L rows of dh: 4*L^2*dh per sequence forward (QK^T and
    PV), 2.5x that backward; q, k, v (and o, do, the fp32 lse) read once, o
    (dq, dk, dv) written once."""
    elems = heads * l * head_dim
    ops = 4.0 * l * l * head_dim * heads
    if backward:
        return 2.5 * ops, 8 * elems * 2 + heads * l * 4
    return ops, 4 * elems * 2


def profile_step(step_fn: Callable, steps: int = 1) -> dict:
    """Profile ``steps`` calls of ``step_fn`` on the card with
    ``torch.profiler`` (CPU and CUDA activity), synchronized before and after.

    Returns ``kernels``: {kernel name: (device ms, launches)}, the largest
    first; ``device_ms``, their sum; ``window_ms``, from the first traced
    event's start to the last one's end; ``busy_share``, the union of the
    kernels' intervals over the window. Raises if the trace holds no device
    time (a profiler that cannot see the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = list(prof.events())
    spans = device_intervals(events, DeviceType.CUDA)
    if not spans or sum(b - a for a, b, _ in spans) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    kernels = {}
    for a, b, name in spans:
        ms, n = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + (b - a) / 1e3, n + 1)
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    return {"kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1][0])),
            "device_ms": sum(ms for ms, _ in kernels.values()),
            "window_ms": (t1 - t0) / 1e3, "busy_share": covered(spans) / (t1 - t0)}


def span_cost_us(n: int = 200000, n_traced: int = 20000) -> dict:
    """Microseconds a ``trace_span`` enter and exit costs on this host:
    ``off`` with no profiler (NVTX included on a machine with a card),
    ``on`` under ``torch.profiler`` (CPU, and CUDA activity with a card),
    ``count`` one counter increment with no profiler,
    ``record_function_off`` a bare ``record_function`` range with no
    profiler, what every span cost before the guard, and ``nvtx`` (with a
    card) an NVTX push and pop, what a span adds under an NVTX tool."""
    from torch.profiler import ProfilerActivity, profile

    from .utils.logging import count, trace_span

    def per_call(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def span():
        with trace_span("sam3.cost"):
            pass

    def bare():
        with torch.profiler.record_function("sam3.cost"):
            pass

    def nvtx():
        torch.cuda.nvtx.range_push("sam3.cost")
        torch.cuda.nvtx.range_pop()

    out = {"off": per_call(span, n), "count": per_call(lambda: count("span_cost"), n),
           "record_function_off": per_call(bare, n)}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        out["nvtx"] = per_call(nvtx, n)
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        out["on"] = per_call(span, n_traced)
    return out


def device_intervals(events, device_type) -> list:
    """Sorted (start us, end us, name) of the events of ``device_type`` that
    are device work (kernels, copies, sets): a host range (a span such as
    ``sam3.forward``) also shows on the device's timeline under its own name,
    as a user annotation, and is left out."""
    host = {e.name for e in events if e.device_type != device_type}
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == device_type and e.name not in host)


def covered(spans) -> float:
    """The length of the union of (start, end, ...) intervals sorted by
    start: the time at least one of them runs."""
    total, end = 0.0, float("-inf")
    for a, b, *_ in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total
