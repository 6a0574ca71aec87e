"""The program's own spans and counters in a traced window, and the device's
idle time put down to the stage that left it idle.

The port names its spans ``sam3.<stage>`` (``sam3_lora_tpu_torch/utils/
logging.py::trace_span``) and its blocking transfers ``sam3.sync.<site>``;
its counters are ``host_syncs`` and ``d2h_bytes``. A reader takes them from
``ctx["program_spans"]`` and ``ctx["counters"]`` where the context holds
them, else from what the program recorded while the profiler ran
(``utils.logging.recorded``: the same spans, on the profiler's clock),
clipped to the window. A program without that record (an older checkout)
gives None, never 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Interval, gaps

PREFIX = "sam3."
SYNC = PREFIX + "sync."
# the benchmark's span around one unit of each entry of ``entries.py``; a
# driver of ``benchmark/drivers/`` names its span as its unit
UNIT_SPAN = {"train": "train_step", "request": "request", "prompt": "prompt"}


def spans(prof, window: Tuple[float, float]) -> List[Interval]:
    """The host ranges named ``sam3.*`` of a ``torch.profiler`` trace, clipped
    to ``window`` as ``trace.intervals`` clips its own spans."""
    from .trace import _events

    out = []
    for n, is_dev, a, b in _events(prof):
        a, b = max(a, window[0]), min(b, window[1])
        if not is_dev and n.startswith(PREFIX) and b > a:
            out.append((a, b, n))
    return sorted(out)


def window_of(ctx) -> Optional[Tuple[float, float]]:
    """The traced window's bounds as far as the context shows them: the
    first and last of its device intervals and benchmark spans, all clipped
    to the window."""
    ends = [x for a, b, _ in list(ctx["device"]) + list(ctx["spans"]) for x in (a, b)]
    return (min(ends), max(ends)) if ends else None


def _record():
    try:
        from sam3_lora_tpu_torch.utils.logging import recorded
    except ImportError:
        return None
    return recorded()


def program_spans(ctx) -> Optional[List[Interval]]:
    """The window's ``sam3.*`` spans (start s, end s, name), or None."""
    if ctx.get("program_spans") is not None:
        return ctx["program_spans"]
    rec, win = _record(), window_of(ctx)
    if rec is None or win is None:
        return None
    out = []
    for n, a, b in rec[0]:
        a, b = max(a / 1e9, win[0]), min(b / 1e9, win[1])
        if b > a:
            out.append((a, b, n))
    return sorted(out) or None


def counters(ctx) -> Optional[Dict[str, int]]:
    """The program's counters' increments in the window, or None."""
    if ctx.get("counters") is not None:
        return ctx["counters"]
    rec, win = _record(), window_of(ctx)
    if rec is None or win is None or program_spans(ctx) is None:
        return None
    out: Dict[str, int] = {}
    for n, t, k in rec[1]:
        if win[0] <= t / 1e9 <= win[1]:
            out[n] = out.get(n, 0) + k
    return out


def units(ctx) -> int:
    """The units (updates, requests, prompts, ...) the traced window started:
    the benchmark's spans named by ``UNIT_SPAN``, else by the unit itself."""
    name = UNIT_SPAN.get(ctx["unit"], ctx["unit"])
    return sum(1 for s in ctx["spans"] if s[2] == name)


def owners(spans: Sequence[Interval]) -> List[Interval]:
    """Disjoint (start, end, name) stretches, each named by the innermost
    program span open there; a ``sam3.sync.*`` span counts with the span it
    is nested in. The spans nest (one thread opens them all)."""
    events = []
    for i, (a, b, n) in enumerate(spans):
        if not n.startswith(SYNC):
            events.append((a, 1, -b, i))  # at one instant ends go first,
            events.append((b, 0, -a, i))  # the outer span opens first, closes last
    events.sort()
    out, stack, prev = [], [], None
    for t, is_start, _, i in events:
        if stack and t > prev:
            out.append((prev, t, spans[stack[-1]][2]))
        if is_start:
            stack.append(i)
        else:
            stack.remove(i)
        prev = t
    return out


def idle_by_span(dev: Sequence[Interval], spans: Sequence[Interval],
                 window: Tuple[float, float]) -> Dict[str, float]:
    """Device-idle seconds (the window less the union of the device
    intervals) in the self time of each program span name."""
    out: Dict[str, float] = {}
    idle = gaps(dev, window)
    i = 0
    for a, b, n in owners(spans):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            lap = min(b, idle[j][1]) - max(a, idle[j][0])
            if lap > 0:
                out[n] = out.get(n, 0.0) + lap
            j += 1
    return out


def idle_in(dev: Sequence[Interval], spans: Sequence[Interval], window: Tuple[float, float],
            names: Sequence[str]) -> float:
    """Device-idle seconds in the self time of the spans named ``names``
    (their nested ``sam3.sync.*`` spans counted with them)."""
    by = idle_by_span(dev, spans, window)
    return sum(by.get(n, 0.0) for n in names)


def idle_ms_per_unit(ctx, unit_kinds: Sequence[str], names: Sequence[str]) -> Optional[float]:
    """A reader's number: the idle ms a unit in ``names``; None where the
    cell's unit is not among ``unit_kinds`` or nothing was recorded."""
    if ctx["unit"] not in unit_kinds:
        return None
    sp, n = program_spans(ctx), units(ctx)
    if sp is None or n == 0:
        return None
    return 1e3 * idle_in(ctx["device"], sp, window_of(ctx), names) / n


def counter_per_unit(ctx, unit_kinds: Sequence[str], name: str,
                     scale: float = 1.0) -> Optional[float]:
    """A reader's number: counter ``name`` a unit, times ``scale``."""
    if ctx["unit"] not in unit_kinds:
        return None
    c, n = counters(ctx), units(ctx)
    if c is None or n == 0:
        return None
    return scale * c.get(name, 0) / n
