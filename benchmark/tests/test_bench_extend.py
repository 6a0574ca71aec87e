"""A configuration, a traffic mix and a per-layer metric are each added as
new files, with a new cell in BENCHMARK.json, in a copy of the benchmark:
the harness runs the cell and reports the metric with no other edit."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.repo_root()


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "sam3-lora8-bf16.json"))
    cfg["lora"]["rank"] = 4
    json.dump(cfg, open(b / "configs" / "dummy-cfg.json", "w"))
    traffic = json.load(open(b / "traffic" / "prompts-8.json"))
    traffic["prompts_per_session"] = 2
    json.dump(traffic, open(b / "traffic" / "dummy-mix.json", "w"))
    json.dump(json.load(open(b / "limits" / "prompts-bf16-8.json")),
              open(b / "limits" / "dummy-cell.json", "w"))
    (b / "metrics" / "prompts_per_image.py").write_text(
        "def read(ctx):\n"
        "    return ctx['work']['flops'] and len([s for s in ctx['spans'] if s[2] == 'prompt'])"
        " / max(1, len([s for s in ctx['spans'] if s[2] == 'set_image']))\n")
    bench["configs"].append({"name": "dummy-cfg", "source": "https://example.org/x",
                             "file": "benchmark/configs/dummy-cfg.json", "reduced": ["lora"],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "prompts_per_image", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "serve_requests_per_s", "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("workloads") and "prompts-bf16-8" in m["workloads"]:
            m["workloads"].append("dummy-cell")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json; from benchmark import harness; from benchmark.tests.tiny import tiny; "
            "r = harness.run('dummy-cell', 5, 1.0, True, device='cpu', alter=tiny); "
            "print(json.dumps(r['metrics']))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    metrics = json.loads(p.stdout.strip().splitlines()[-1])
    assert metrics["prompts_per_image"]["value"] > 0
    assert "serve_mfu" in metrics and "idle_share.serve" in metrics
