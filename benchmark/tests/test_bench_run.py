"""Whole runs of the harness at the tiny size on the CPU: the result line,
the refusal without a card, no JAX, the reference's agreement with the
program, and ``correct`` false under each fault the cells can have."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny

ROOT = harness.repo_root()
SEED = 2**33 + 17
LOOSE = {"train": {"loss_gap": 1e-2, "grad_gap": 1e-2, "update_gap": 5e-2},
         "serve": {"score_gap": 1e-3, "box_gap": 1e-3, "mask_gap": 1e-2, "unmatched": 0}}


def run(workload, limits=None, traced=False, **model):
    return harness.run(workload, SEED, 1.0, traced, device="cpu",
                       alter=lambda f: tiny(f, **model), limits=limits)


@pytest.mark.parametrize("workload", ["train-int8-b8", "prompts-bf16-8"])
def test_result_line(workload, capsys):
    r = run(workload, traced=workload.startswith("train"))
    harness.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    if workload.startswith("train"):
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "train_mfu" in line["metrics"] and "idle_share.train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"serve_requests_per_s", "serve_request_p90_ms",
                                        "setup_s"}


@pytest.mark.parametrize("workload,kind", [("train-bf16-b4", "train"), ("serve-int8-1to3", "serve"),
                                           ("prompts-bf16-8", "serve")])
def test_reference_agrees_with_the_program(workload, kind):
    r = run(workload, limits=LOOSE[kind], base_quant="none")
    assert r["correct"], r["checks"]


def test_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "train-int8-b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_jax_after_a_drive():
    code = ("import sys; from benchmark import harness; from benchmark.tests.tiny import tiny; "
            "harness.run('serve-int8-1to3', 3, 0.5, True, device='cpu', alter=tiny); "
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files: the run
    stops with an error and prints no result."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("from benchmark import harness; "
            "harness.emit(harness.run('serve-int8-1to3', 1, 1.0, False, device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "sam3_lora_tpu_torch" in p.stderr
