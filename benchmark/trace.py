"""The traced run's reduction: a ``torch.profiler`` trace of the measured
window -> device intervals by kernel name, the benchmark's own host spans,
the busy seconds (the union of the device intervals), and the breakdown.

Spans are ``record_function`` ranges named ``bench:<what>`` that the
harness opens around its calls into the program; they land in the same
trace, on the same clock, as the kernels. ``bench:window`` bounds the
measured window; everything is clipped to it.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "bench:"

Interval = Tuple[float, float, str]  # (start s, end s, name)


@contextlib.contextmanager
def span(name: str):
    """A host span in the trace (a no-op cost when nothing profiles)."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    """(name, is_device, start s, end s) of every event of the trace, read
    once a profiler: a window's trace holds millions, at some µs each."""
    out = getattr(prof, "bench_events", None)
    if out is None:
        out = prof.bench_events = _read_events(prof)
    return out


def _read_events(prof):
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        out = []
        for e in raw:
            start = e.start_ns() / 1e9
            out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                        start + e.duration_ns() / 1e9))
        return out
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start / 1e6,
                 e.time_range.end / 1e6) for e in prof.events()]


def intervals(prof) -> Tuple[List[Interval], List[Interval], Tuple[float, float]]:
    """-> (device intervals, host spans, (window start, window end)), all
    clipped to the ``bench:window`` span."""
    events = _events(prof)
    windows = [(a, b) for n, dev, a, b in events if not dev and n == SPAN_PREFIX + "window"]
    if not windows:
        raise RuntimeError("the trace holds no bench:window span")
    w0, w1 = windows[0]
    # a host range also shows on the device's timeline under its own name
    # (a user annotation): only kernels, copies and sets are device work
    host_names = {n for n, is_dev, _, _ in events if not is_dev}
    dev, spans = [], []
    for n, is_dev, a, b in events:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if is_dev:
            if n in host_names:
                continue
            dev.append((a, b, n))
        elif n.startswith(SPAN_PREFIX) and n != SPAN_PREFIX + "window":
            spans.append((a, b, n[len(SPAN_PREFIX):]))
    dev.sort()
    spans.sort()
    return dev, spans, (w0, w1)


def covered(spans: List[Interval]) -> float:
    """The length of the union of intervals sorted by start."""
    total, end = 0.0, float("-inf")
    for a, b, *_ in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(dev: List[Interval], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The idle stretches of the window between device intervals."""
    out, end = [], window[0]
    for a, b, _ in dev:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if window[1] > end:
        out.append((end, window[1]))
    return out


def device_seconds(dev: List[Interval], patterns) -> float:
    """Device seconds of the intervals whose name contains any pattern."""
    return sum(b - a for a, b, n in dev if any(p in n for p in patterns))


def breakdown(dev: List[Interval], spans: List[Interval], window) -> Dict:
    """The 10 device operations of most time, and the 10 longest idle gaps,
    each named by the innermost host span open over it (``host`` where none
    is): a gap is cut where a span opens or closes. ``spans`` may hold the
    benchmark's spans and the program's, which nest inside them."""
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    pieces = []
    for a, b in gaps(dev, window):
        cuts = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        pieces += zip(cuts, cuts[1:])
    named = []
    for a, b in sorted(pieces, key=lambda g: g[0] - g[1])[:10]:
        open_ = [s for s in spans if s[0] <= a < s[1]]
        inner = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "host"
        named.append([inner, b - a])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}
