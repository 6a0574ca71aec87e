"""A cell brings its own driver as a new file: ``benchmark/drivers/<entry>.py``
with its ``ENTRY``, found by the traffic's ``entry`` (``harness.entry_class``),
its unit counted by its own span (``program.units``), and the result's idle
gaps named by the program's spans (``trace.breakdown``).

``toy_checkout(dst)`` writes the toy cell's checkout (a copy of the
benchmark, the new files and a copy of ``BENCHMARK.json`` with the cell);
``python -m benchmark.run --workload toy-frames-32 ...`` runs it from there
on a card, with the repo root on ``PYTHONPATH`` for the program."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, program, trace
from benchmark.entries import ENTRIES, Predict, Processor, Train

ROOT = harness.repo_root()
CELL = "toy-frames-32"

DRIVER = '''"""A toy video driver: each frame one seeded step of a carried state,
``x <- tanh(x @ w + u)`` (``w`` a contraction, ``u`` the clip's input), in
the program's span ``sam3.forward``; a clip is ``frames_per_clip`` frames
from ``x = u``; the first clip's end state is checked against a float64
recomputation on the host."""

import statistics
import time

import torch

from benchmark.entries import Entry
from benchmark.trace import span
from sam3_lora_tpu_torch.utils.logging import trace_span


class Frames(Entry):
    unit = "frame"

    def setup(self):
        g = torch.Generator().manual_seed(self.seed % 2**63)
        n, b = self.config["width"], self.config["batch"]
        self.w = torch.randn(n, n, generator=g, dtype=torch.float64) * (0.5 / n ** 0.5)
        self.u = torch.randn(b, n, generator=g, dtype=torch.float64)
        self.w_dev = self.w.to(self.device, torch.float32)
        self.u_dev = self.u.to(self.device, torch.float32)
        self.clip()  # the one shape, warmed up

    def step(self, x):
        with trace_span("sam3.forward"):
            return torch.tanh(x @ self.w_dev + self.u_dev)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def clip(self, timed=False):
        x = self.u_dev
        for _ in range(self.traffic["frames_per_clip"]):
            ts = time.perf_counter()
            if timed:
                self.attempted += 1
                with span("frame"):
                    x = self.step(x)
                    self.sync()
                self.latencies.append(time.perf_counter() - ts)
            else:
                x = self.step(x)
        self.sync()
        return x

    def window(self, seconds):
        self.first = None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            x = self.clip(timed=True)
            if self.first is None:
                self.first = x.cpu()

    def e2e(self, window_s):
        return {"serve_requests_per_s": self.attempted / window_s,
                "serve_request_p90_ms": statistics.quantiles(self.latencies, n=10)[-1] * 1e3}

    def close(self):
        del self.w_dev, self.u_dev

    def work(self):
        n, b = self.config["width"], self.config["batch"]
        return {"flops": 2.0 * b * n * n * self.attempted, "attn": (0.0, 0.0, 0.0),
                "int8": (0.0, 0.0, 0.0)}

    def check(self):
        x = self.u
        for _ in range(self.traffic["frames_per_clip"]):
            x = torch.tanh(x @ self.w + self.u)
        return {"state_gap": float((self.first.double() - x).abs().max())}


ENTRY = Frames
'''

READER = '''"""Device-idle ms a frame in the program's span ``sam3.forward``."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("frame",), ("sam3.forward",))
'''

NEW_FILES = {
    "benchmark/drivers/toy-frames.py": DRIVER,
    "benchmark/metrics/frame_forward_idle_ms.py": READER,
    "benchmark/configs/toy-mlp.json": json.dumps({"width": 384, "batch": 32}),
    "benchmark/traffic/frames-32.json": json.dumps({"entry": "toy-frames",
                                                    "frames_per_clip": 32}),
    f"benchmark/limits/{CELL}.json": json.dumps({"state_gap": 1e-3}),
}


def _ignore(_, names):
    return [n for n in names if n in ("__pycache__", ".cache")]


def toy_checkout(dst) -> str:
    """A copy of the benchmark with the toy cell added as new files only."""
    dst = str(dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=_ignore)
    for rel, text in NEW_FILES.items():
        path = os.path.join(dst, rel)
        assert not os.path.exists(path), rel
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-mlp", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy-mlp.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "toy-mlp", "traffic": "frames-32",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frame_forward_idle_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "model forward", "moves": "serve_requests_per_s",
                               "workloads": [CELL]})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_requests_per_s", "serve_request_p90_ms"):
            m["workloads"].append(CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dst


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_a_driver_file_makes_a_new_cell(tmp_path):
    toy_checkout(tmp_path)
    code = ("import json; from benchmark import harness; "
            f"rs = [harness.run({CELL!r}, 2**31 + 7, 1.0, t, device='cpu') for t in (False, True)]; "
            "print(json.dumps({'runs': [harness._finite(r) for r in rs], "
            "'forbidden': harness.forbidden_modules()}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    plain, traced = out["runs"]
    assert out["forbidden"] == []
    for r in (plain, traced):
        assert r["correct"], r["checks"]
        assert r["attempted"] > 0 and r["failed"] == 0
    assert set(plain["metrics"]) == {"serve_requests_per_s", "serve_request_p90_ms", "setup_s"}
    assert set(traced["metrics"]) == {"frame_forward_idle_ms"}
    assert traced["metrics"]["frame_forward_idle_ms"]["value"] > 0
    assert any(n.startswith("sam3.") for n, _ in traced["breakdown"]["idle_gaps"])
    # every file copied from the repo left as it was
    for d, dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", ".cache")]
        for name in files:
            src = os.path.join(d, name)
            copy = os.path.join(tmp_path, os.path.relpath(src, ROOT))
            assert _same_bytes(src, copy), os.path.relpath(src, ROOT)


def test_an_unknown_entry_names_the_file_it_looked_for():
    with pytest.raises(FileNotFoundError, match="benchmark/drivers/no-such-entry.py"):
        harness.entry_class("no-such-entry")
    with pytest.raises(FileNotFoundError, match="benchmark/drivers/no-such-entry.py"):
        harness.run("serve-int8-1to3", 1, 1.0, False, device="cpu",
                    alter=lambda f: f["traffic"].update(entry="no-such-entry"))


@pytest.mark.parametrize("workload,cls", [("train-int8-b8", Train), ("serve-int8-1to3", Predict),
                                          ("train-bf16-b4", Train),
                                          ("prompts-bf16-8", Processor)])
def test_the_cells_keep_their_classes(workload, cls):
    entry = harness.cell_files(workload)["traffic"]["entry"]
    assert harness.entry_class(entry) is ENTRIES[entry] is cls


@pytest.mark.parametrize("unit,span", [("train", "train_step"), ("request", "request"),
                                       ("prompt", "prompt"), ("frame", "frame")])
def test_units_count_the_unit_span(unit, span):
    names = ["train_step", "request", "prompt", "frame", "data_wait", "set_image"]
    spans = [(float(i), i + 0.5, n) for i, n in enumerate(names * 3)]
    assert program.units({"unit": unit, "spans": spans}) == 3


class _Event:
    """A profiler event as ``trace._events`` reads it."""

    def __init__(self, name, cuda, a, b):
        self._n, self._c, self._a, self._b = name, cuda, a, b

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return round(self._a * 1e9)

    def duration_ns(self):
        return round((self._b - self._a) * 1e9)


def test_breakdown_names_a_gap_by_the_innermost_span():
    # idle: 1-3 (forward, its sync 1.5-2), 4-6 (train_step, backward 4.5-5.5), 9.5-10
    dev = [(0.0, 1.0, "k"), (3.0, 4.0, "k"), (6.0, 9.5, "k")]
    bench = [(0.5, 9.0, "train_step")]
    ours = [(0.75, 3.5, "sam3.forward"), (1.5, 2.0, "sam3.sync.scores"),
            (4.5, 5.5, "sam3.backward")]
    assert trace.breakdown(dev, bench, (0.0, 10.0))["idle_gaps"] == [
        ["train_step", 2.0], ["train_step", 2.0], ["host", 0.5]]
    assert trace.breakdown(dev, bench + ours, (0.0, 10.0))["idle_gaps"] == [
        ["sam3.forward", 1.0], ["sam3.backward", 1.0], ["sam3.forward", 0.5],
        ["sam3.sync.scores", 0.5], ["train_step", 0.5], ["train_step", 0.5], ["host", 0.5]]
    # the same through a trace, as ``harness.run`` takes the two kinds of span
    events = [_Event("bench:window", False, 0.0, 10.0)]
    events += [_Event(n, True, a, b) for a, b, n in dev]
    events += [_Event("bench:" + n, False, a, b) for a, b, n in bench]
    events += [_Event(n, False, a, b) for a, b, n in ours]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    d, spans, win = trace.intervals(prof)
    gaps = trace.breakdown(d, spans + program.spans(prof, win), win)["idle_gaps"]
    assert [n for n, _ in gaps] == ["sam3.forward", "sam3.backward", "sam3.forward",
                                    "sam3.sync.scores", "train_step", "train_step", "host"]
    assert [s for _, s in gaps] == pytest.approx([1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5])
