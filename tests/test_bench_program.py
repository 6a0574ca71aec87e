"""The benchmark's reading of the program's spans and counters
(``benchmark/program.py`` and its ten readers): the idle time put down to
the innermost program span on a written trace, the readers on a written
context, their fallback to what the program recorded under a profiler, and
the benchmark's own readers and breakdown unchanged by program spans in the
trace."""

import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program, trace
from sam3_lora_tpu_torch.utils import logging as tl

TRAIN_READERS = ("data_idle_ms.train", "forward_idle_ms.train", "match_idle_ms.train",
                 "backward_idle_ms.train", "host_syncs.train")
SERVE_READERS = ("preprocess_idle_ms.serve", "forward_idle_ms.serve", "post_idle_ms.serve",
                 "host_syncs.serve", "d2h_mb.serve")
OLD_READERS = ("idle_share.train", "idle_share.serve", "train_mfu", "serve_mfu",
               "attn_roofline.train", "attn_roofline.serve", "gemm_int8_roofline.train",
               "gemm_int8_roofline.serve", "data_wait_ms.train")


def test_idle_in_takes_self_time_and_splits_straddling_gaps():
    spans = [(0.0, 10.0, "sam3.train_step"), (1.0, 6.0, "sam3.forward"),
             (3.0, 5.0, "sam3.match"), (3.5, 4.5, "sam3.sync.match_cost"),
             (6.0, 9.0, "sam3.backward")]
    dev = [(0.0, 2.0, "k"), (2.5, 3.2, "k"), (4.0, 4.2, "Memcpy DtoH"), (5.5, 7.0, "k")]
    # idle: 2-2.5 (forward), 3.2-4 and 4.2-5 (match, its sync with it),
    # 5-5.5 (forward), 7-9 (backward), 9-10 (train_step's self time)
    by = program.idle_by_span(dev, spans, (0.0, 10.0))
    assert by == pytest.approx({"sam3.forward": 1.0, "sam3.match": 1.6, "sam3.backward": 2.0,
                                "sam3.train_step": 1.0})
    assert "sam3.sync.match_cost" not in by
    assert program.idle_in(dev, spans, (0.0, 10.0), ("sam3.match", "sam3.backward")) == \
        pytest.approx(3.6)
    assert program.idle_in(dev, spans, (0.0, 10.0), ("sam3.loss",)) == 0.0
    # a gap from one span into the next, and one past the last span
    spans = [(0.0, 2.0, "sam3.preprocess"), (2.0, 5.0, "sam3.forward")]
    by = program.idle_by_span([(0.0, 1.0, "k"), (3.0, 4.0, "k")], spans, (0.0, 6.0))
    assert by == pytest.approx({"sam3.preprocess": 1.0, "sam3.forward": 2.0})


def test_owners_nest_at_shared_instants():
    spans = [(0.0, 4.0, "sam3.forward"), (0.0, 2.0, "sam3.match"), (2.0, 4.0, "sam3.loss")]
    assert program.owners(spans) == [(0.0, 2.0, "sam3.match"), (2.0, 4.0, "sam3.loss")]


def ctx(unit, **kw):
    base = {"unit": unit, "window_s": 10.0, "busy_s": 3.5,
            "device": [(0.0, 1.5, "attention_fwd_kernel"), (5.0, 7.0, "dq_kernel")],
            "spans": [(0.0, 5.0, UNIT[unit]), (5.0, 10.0, UNIT[unit])],
            "work": {"flops": 989e12, "attn": (0, 0, 1.0), "int8": (0, 0, 1.0)},
            "data_wait_s": [0.01, 0.03],
            "program_spans": [(0.0, 5.0, "sam3.forward"), (2.0, 3.0, "sam3.match"),
                              (3.0, 4.0, "sam3.preprocess"), (4.0, 5.0, "sam3.post"),
                              (4.2, 4.4, "sam3.sync.masks"), (5.0, 6.0, "sam3.data.wait"),
                              (7.0, 8.0, "sam3.loss"), (8.0, 9.0, "sam3.backward"),
                              (9.0, 9.5, "sam3.update"), (9.5, 10.0, "sam3.data.pin")],
            "counters": {"host_syncs": 7, "d2h_bytes": 3_000_000}}
    base.update(kw)
    return base


UNIT = {"train": "train_step", "request": "request", "prompt": "prompt"}


def test_readers():
    # idle: 1.5-5 and 7-10; two units in the window
    r = {n: harness.reader(n) for n in TRAIN_READERS + SERVE_READERS}
    t = ctx("train")
    assert r["data_idle_ms.train"](t) == pytest.approx(250.0)  # 9.5-10 (6 is busy)
    assert r["forward_idle_ms.train"](t) == pytest.approx(250.0)  # 1.5-2: not match, pre, post
    assert r["match_idle_ms.train"](t) == pytest.approx(1000.0)  # 2-3, 7-8
    assert r["backward_idle_ms.train"](t) == pytest.approx(750.0)  # 8-9.5
    assert r["host_syncs.train"](t) == pytest.approx(3.5)
    for unit in ("request", "prompt"):
        s = ctx(unit)
        assert r["preprocess_idle_ms.serve"](s) == pytest.approx(500.0)
        assert r["forward_idle_ms.serve"](s) == pytest.approx(250.0)
        assert r["post_idle_ms.serve"](s) == pytest.approx(500.0)  # its sync with it
        assert r["host_syncs.serve"](s) == pytest.approx(3.5)
        assert r["d2h_mb.serve"](s) == pytest.approx(1.5)
    for name in TRAIN_READERS:
        assert r[name](ctx("request")) is None
    for name in SERVE_READERS:
        assert r[name](ctx("train")) is None


def test_readers_find_nothing_without_program_spans(monkeypatch):
    monkeypatch.setattr(program, "_record", lambda: None)  # a program that records nothing
    for name in TRAIN_READERS + SERVE_READERS:
        unit = "train" if name.endswith(".train") else "prompt"
        assert harness.reader(name)(ctx(unit, program_spans=None, counters=None)) is None
    monkeypatch.setattr(program, "_record", lambda: ([], []))  # nothing in this window
    assert harness.reader("host_syncs.serve")(
        ctx("prompt", program_spans=None, counters=None)) is None
    assert harness.reader("forward_idle_ms.train")(ctx("train", spans=[])) is None  # no unit


def test_readers_fall_back_to_the_program_record():
    """Without ``program_spans`` in the context, a reader takes the spans and
    counter increments the program recorded under the profiler, on its
    clock, clipped to the window the context's intervals show."""
    x = torch.ones(4, 4)
    tl.to_host(x, "before")  # outside the profiler: counted, not recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns() / 1e9
        with tl.trace_span("sam3.set_text_prompt"):
            with tl.trace_span("sam3.post"):
                tl.to_host(x, "scores")
                tl.to_host(x[0], "masks")
        t1 = time.time_ns() / 1e9
    c = ctx("prompt", program_spans=None, counters=None, window_s=t1 - t0, busy_s=0.0,
            device=[], spans=[(t0, t1, "prompt")])
    got = program.program_spans(c)
    assert [n for _, _, n in got] == ["sam3.set_text_prompt", "sam3.post", "sam3.sync.scores",
                                      "sam3.sync.masks"]
    assert program.counters(c) == {"host_syncs": 2, "d2h_bytes": 64 + 16}
    assert harness.reader("d2h_mb.serve")(c) == pytest.approx(80e-6)
    # the trace holds the same spans, each inside the record's
    traced = program.spans(prof, (t0 - 1.0, t1 + 1.0))
    assert [n for _, _, n in traced] == [n for _, _, n in got]
    for (a, b, _), (ra, rb, _) in zip(traced, got):
        assert ra <= a + 1e-6 and b <= rb + 1e-6


class _Event:
    def __init__(self, name, cuda, a, b):
        self._n, self._c, self._a, self._b = name, cuda, a, b

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return int(self._a * 1e9)

    def duration_ns(self):
        return int((self._b - self._a) * 1e9)


def _prof(events):
    kineto = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=kineto))


def test_old_readers_and_breakdown_unchanged_by_program_spans():
    base = [_Event("bench:window", False, 0.0, 10.0), _Event("bench:train_step", False, 0.5, 9.0),
            _Event("bench:train_step", True, 0.5, 9.0),
            _Event("void attention_fwd_kernel<64>", True, 1.0, 2.0),
            _Event("dq_kernel", True, 3.0, 4.0),
            _Event("void sam3::sm90::gemm_kernel<(anonymous namespace)::S8Scaled>", True, 4.0,
                   6.0), _Event("Memcpy DtoH (Device -> Pageable)", True, 7.0, 7.1)]
    ours = [_Event("sam3.train_step", False, 0.6, 8.9), _Event("sam3.train_step", True, 0.6, 8.9),
            _Event("sam3.forward", False, 0.7, 5.0), _Event("sam3.forward", True, 0.7, 5.0),
            _Event("sam3.sync.match_cost", False, 6.5, 7.2)]
    out = []
    for events in (base, base + ours):
        dev, spans, win = trace.intervals(_prof(events))
        c = {"workload": "x", "unit": "train", "window_s": win[1] - win[0],
             "busy_s": trace.covered(dev), "device": dev, "spans": spans,
             "work": {"flops": 1e12, "attn": (0, 0, 0.5), "int8": (0, 0, 0.5)},
             "data_wait_s": [0.02]}
        reads = {n: harness.reader(n)(c) for n in OLD_READERS}
        reads["request"] = {n: harness.reader(n)(dict(c, unit="request")) for n in OLD_READERS}
        out.append((dev, spans, reads, trace.breakdown(dev, spans, win)))
    assert out[0] == out[1]
    assert out[0][2]["idle_share.train"] == pytest.approx(59.0)


def test_idle_audit_holds_each_sync_span_to_its_copy():
    from benchmark.idle_audit import hold

    copies = [1.0, 2.00001, 5.0]
    syncs = [(0.5, 1.00001, "sam3.sync.scores"),  # its copy ends 10 µs before it
             (1.9, 2.0, "sam3.sync.masks"),  # 10 µs after it: inside the slack
             (3.0, 4.0, "sam3.sync.keep")]  # none: the nearest ends 1 s after it
    out = hold(copies, syncs)
    assert out["held"] == pytest.approx(2 / 3)
    assert out["end_less_copy_us"]["min"] == pytest.approx(-10.0, abs=1e-3)
    assert out["end_less_copy_us"]["max"] == pytest.approx(10.0, abs=1e-3)
    assert out["sites"] == {"keep": [1, 0], "masks": [1, 1], "scores": [1, 1]}
    assert out["misses"] == [(4.0, "keep", 1.0)]


def test_graph_replays_reader_counts_a_unit_and_is_silent_without_the_cache(monkeypatch):
    read = harness.reader("graph_replays.serve")
    for unit in ("request", "prompt"):
        assert read(ctx(unit, counters={"graph_replays": 9, "host_syncs": 2})) == pytest.approx(4.5)
        assert read(ctx(unit, counters={"host_syncs": 2})) == 0.0  # the cache never engaged
    assert read(ctx("train")) is None
    # a program without the graph cache (an older checkout) gives nothing
    import importlib.util

    found = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "sam3_lora_tpu_torch.graphs"
                        else found(name, *a))
    assert read(ctx("request")) is None
