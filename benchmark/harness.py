"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic file
``benchmark/traffic/<traffic>.json``, whose ``entry`` names the driver (a
class of ``entries.ENTRIES``, else the ``ENTRY`` of
``benchmark/drivers/<entry>.py``: ``entry_class``), its limits
``benchmark/limits/<workload>.json``, and each per-layer metric's reader
``benchmark/metrics/<metric>.py`` (a function ``read(ctx)`` that returns a
number, or None when it finds nothing). A new cell is new files and new
entries in ``BENCHMARK.json``: a driver, a reader or a traffic mix is
never an edit to a file the benchmark has.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from . import compare, program, trace
from .entries import ENTRIES, make_workdir, remove_workdir

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sam3_lora_tpu")


def repo_root() -> str:
    return os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str) -> Dict:
    """The cell's entries and files, by the names in ``BENCHMARK.json``."""
    root = repo_root()
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "bench": bench, "cell": cell,
        "config": load_json(os.path.join(root, cfg["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", workload + ".json")),
    }


def reports(metric: Dict, workload: str, e2e_names) -> bool:
    """Whether a cell reports ``metric``: the cells its ``workloads`` key
    lists, or, without one, every cell (end-to-end) or every cell that
    reports the end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def _load(path: str, module: str):
    """The module of the file at ``path``, registered as ``module`` (a
    dataclass or a pickle looks its module up by name)."""
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"benchmark_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


def reader(name: str) -> Callable:
    return _load(os.path.join(HERE, "metrics", name + ".py"), _module_name("metric", name)).read


def entry_class(name: str) -> type:
    """The driver of a traffic file's ``entry``: the class ``entries.ENTRIES``
    holds under ``name``, else the ``ENTRY`` of ``benchmark/drivers/<name>.py``
    (a subclass of ``entries.Entry``)."""
    if name in ENTRIES:
        return ENTRIES[name]
    path = os.path.join(HERE, "drivers", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no entry {name!r}: not one of {sorted(ENTRIES)}, and no "
                                f"{os.path.relpath(path, repo_root())}")
    module = _module_name("driver", name)
    return (sys.modules.get(module) or _load(path, module)).ENTRY


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda", t_start=None,
        alter: Optional[Callable] = None, limits: Optional[Dict] = None) -> Dict:
    """Run the cell once and return its result line as a dict (with the
    compared numbers under ``checks``). ``alter(files)`` may change the
    loaded files first (the CPU tests' tiny sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    files = cell_files(workload)
    if alter is not None:
        alter(files)
    limits = limits if limits is not None else files["limits"]
    cuda = torch.device(device).type == "cuda"
    workdir = make_workdir()
    try:
        entry = entry_class(files["traffic"]["entry"])(files["config"], files["traffic"], seed,
                                                        device, workdir)
        entry.setup()
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        prof = trace.profiler() if traced else None
        if prof is not None:
            prof.__enter__()
        with trace.span("window"):
            t0 = time.perf_counter()
            entry.window(seconds)
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        e2e = entry.e2e(t1 - t0)
        e2e["peak_gib"] = window_peak / 2 ** 30
        e2e["setup_s"] = setup_s
        entry.close()
        readings = entry.check()
        correct = compare.judge(readings, limits)
        bench, cell = files["bench"], files["cell"]
        e2e_names = [m["name"] for m in bench["end_to_end"] if reports(m, workload, ())]
        metrics = {}
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)
                       if cuda else 0}
        breakdown = None
        if traced:
            dev, spans, win = trace.intervals(prof)
            named = spans + program.spans(prof, win)  # each gap by the innermost span
            del prof
            ctx = {"workload": workload, "unit": entry.unit, "window_s": win[1] - win[0],
                   "busy_s": trace.covered(dev), "device": dev, "spans": spans,
                   "work": entry.work(), "data_wait_s": getattr(entry, "waits", [])}
            for m in bench["per_layer"]:
                if reports(m, workload, e2e_names):
                    value = reader(m["name"])(ctx)
                    if value is not None:
                        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = ctx["busy_s"]
            device_info["window_s"] = ctx["window_s"]
            breakdown = trace.breakdown(dev, named, win)
        else:
            for m in bench["end_to_end"]:
                if reports(m, workload, ()):
                    if m["name"] not in e2e:
                        raise KeyError(f"{workload} reports no {m['name']}")
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    finally:
        remove_workdir(workdir)
    result = {"correct": bool(correct), "attempted": entry.attempted, "failed": entry.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in sorted(limits)}
    result["readings"] = readings
    return result


def emit(result: Dict) -> None:
    """Every reading, then the compared numbers beside their limits as the
    last lines of standard error; the result as the last line of standard
    output, its ``checks`` last."""
    result = dict(result)
    for k, v in sorted(result.pop("readings").items()):
        print(f"reading {k} {v!r}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)))
    sys.stdout.flush()


def _finite(x):
    """JSON has no infinity: a number beyond every limit stands for it."""
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max if x > 0 or math.isnan(x) else -sys.float_info.max
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x
