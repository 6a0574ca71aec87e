"""A traced run of one cell, audited: where the device's idle time went by
the program's spans, and whether the program's record of its spans keeps
the trace's clock.

    python -m benchmark.idle_audit --workload <name> --seed <n> --seconds <s> [--out f.jsonl]

(``--cpu``: a rehearsal on the CPU at the benchmark tests' tiny sizes.)

Runs ``harness.run`` with ``--trace 1`` and prints one JSON line: the
result's metrics; ``units`` and ``idle_s`` (the window less the union of
the device intervals); ``idle_ms`` a unit by the innermost program span
(``program.idle_by_span``; ``none`` where no program span is open) and
``covered``, the share of ``idle_s`` the cell's idle metrics hold;
``clock``: the record's spans against the trace's ``sam3.*`` ranges (their
start and end offsets, µs), each ``sam3.sync.*`` span, of the trace and of
the record, against the last memcpy that ends inside it (20 µs of slack:
the share that holds one, quantiles of span end less copy end, µs, the
counts by site, the misses), and the device intervals a second of the
window; and ``idle_gaps``, the result's breakdown: the ten longest gaps
named by the innermost benchmark or program span. A program without spans
gives the metrics, the units and the gaps alone.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()

SLACK_S = 20e-6
IDLE_METRICS = {
    "train": ("data_idle_ms.train", "forward_idle_ms.train", "match_idle_ms.train",
              "backward_idle_ms.train"),
    "serve": ("preprocess_idle_ms.serve", "forward_idle_ms.serve", "post_idle_ms.serve"),
}


def hold(copies, syncs):
    """Each sync span against the memcpy ends (sorted): the share that hold
    one inside them (``SLACK_S`` of slack), quantiles of span end less the
    last such copy end (µs), by site [spans, held], and each miss as (span
    end, site, nearest copy end less span end, s)."""
    deltas, sites, misses = [], {}, []
    for a, b, n in syncs:
        site = n[len("sam3.sync."):]
        count = sites.setdefault(site, [0, 0])
        count[0] += 1
        i = bisect.bisect_right(copies, b + SLACK_S) - 1
        if i >= 0 and copies[i] >= a - SLACK_S:
            count[1] += 1
            deltas.append((b - copies[i]) * 1e6)
            continue
        near = [copies[j] - b for j in (i, i + 1) if 0 <= j < len(copies)]
        misses.append((b, site, min(near, key=abs) if near else None))
    out = {"syncs": len(syncs), "held": len(deltas) / len(syncs) if syncs else None,
           "sites": dict(sorted(sites.items())), "misses": misses}
    if len(deltas) >= 2:
        q = statistics.quantiles(deltas, n=20)
        out["end_less_copy_us"] = {"min": min(deltas), "p5": q[0], "p50": statistics.median(deltas),
                                   "p95": q[-1], "max": max(deltas)}
    return out


def misses_in(dev, misses, w0, near_s=5e-3):
    """The misses as [s into the window, site, nearest copy end less span
    end (µs), device intervals that end within ``near_s`` of the span end]."""
    ends = sorted(b for _, b, _ in dev)
    out = []
    for b, site, d in misses:
        n = bisect.bisect_right(ends, b + near_s) - bisect.bisect_left(ends, b - near_s)
        out.append([round(b - w0, 4), site, None if d is None else round(d * 1e6, 1), n])
    return out


def clock_check(ctx, prof_spans, rec_spans, win):
    """The record against the trace (matched in order, name by name: how far
    the record's start precedes and its end follows the trace's, µs) and
    the sync spans of each against the memcpys (``hold``)."""
    out = {}
    if [n for _, _, n in prof_spans] == [n for _, _, n in rec_spans]:
        pairs = list(zip(prof_spans, rec_spans))
        for k, key in ((0, "record_start_us"), (1, "record_end_us")):
            d = sorted(abs(r[k] - p[k]) * 1e6 for p, r in pairs)
            out[key] = {"p50": statistics.median(d), "max": d[-1]}
    else:
        out["record_matches_trace"] = False
    copies = sorted(b for _, b, n in ctx["device"] if "Memcpy" in n)
    w0 = win[0]
    for key, sp in (("trace", prof_spans), ("record", rec_spans)):
        out[key] = hold(copies, [s for s in sp if s[2].startswith("sam3.sync.")])
        out[key]["misses"] = misses_in(ctx["device"], out[key]["misses"], w0)[:60]
    bins = [0] * (int(ctx["window_s"]) + 1)
    for a, _, _ in ctx["device"]:
        bins[min(int(a - w0), len(bins) - 1)] += 1
    out["device_intervals_per_s"] = bins
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU at the benchmark tests' tiny sizes")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    from benchmark import harness, program, trace

    seen = {}
    make_profiler = trace.profiler
    make_reader = harness.reader

    def profiler():
        seen["prof"] = make_profiler()
        return seen["prof"]

    def reader(name):
        fn = make_reader(name)

        def read(ctx):
            seen["ctx"] = ctx
            return fn(ctx)
        return read

    trace.profiler, harness.reader = profiler, reader
    try:
        alter = None
        if args.cpu:
            from benchmark.tests.tiny import tiny as alter
        result = harness.run(args.workload, args.seed, args.seconds, True,
                             device="cpu" if args.cpu else "cuda", t_start=T_START, alter=alter)
    finally:
        trace.profiler, harness.reader = make_profiler, make_reader
    ctx, prof = seen["ctx"], seen["prof"]
    _, _, win = trace.intervals(prof)
    n = program.units(ctx)
    idle_s = ctx["window_s"] - ctx["busy_s"]
    line = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
            "units": n, "window_s": ctx["window_s"], "idle_s": idle_s,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "idle_gaps": result["breakdown"]["idle_gaps"]}
    rec = program.program_spans(ctx)
    if rec is not None:
        by = program.idle_by_span(ctx["device"], rec, win)
        by["none"] = idle_s - sum(by.values())
        line["idle_ms"] = {k: 1e3 * v / n for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
        kind = "train" if ctx["unit"] == "train" else "serve"
        held = sum(line["metrics"].get(m, 0.0) for m in IDLE_METRICS[kind]) * n / 1e3
        line["covered"] = held / idle_s if idle_s > 0 else None
        line["counters"] = program.counters(ctx)
        line["clock"] = clock_check(ctx, program.spans(prof, win), rec, win)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
