"""The port's logging utilities (``sam3_lora_tpu_torch/utils/logging.py``)
against the JAX package's: the meters and the ``ProgressMeter`` line, the
JSON-lines fallback of ``TensorBoardLogger`` (line for line),
``setup_logging``'s handlers; and on the
CPU ``MemMeter`` reads 0, ``trace_span`` shows by name in a
``torch.profiler`` trace and ``capture_trace`` writes one."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

import sam3_lora_tpu.utils as jax_utils
import sam3_lora_tpu_torch.utils as port_utils


def test_exports_equal_jax():
    assert port_utils.__all__ == jax_utils.__all__


def _meters(utils):
    loss, lr = utils.AverageMeter("loss"), utils.AverageMeter("lr")
    for v, n in ((0.5, 2), (1.25, 1), (3.0, 4)):
        loss.update(v, n=n)
    lr.update(1e-3)
    return loss, lr


def test_average_and_progress_meters_equal_jax():
    (pl, plr), (jl, jlr) = _meters(port_utils), _meters(jax_utils)
    assert (pl.sum, pl.count, pl.avg) == (jl.sum, jl.count, jl.avg)
    for n_batches, batch in ((120, 7), (9, 9), (1000, 12)):
        port = port_utils.ProgressMeter(n_batches, [pl, plr], prefix="train ").display(batch)
        ref = jax_utils.ProgressMeter(n_batches, [jl, jlr], prefix="train ").display(batch)
        assert port == ref
    pl.reset()
    assert pl.avg == 0.0


def test_mem_meter_reads_zero_on_the_cpu():
    m = port_utils.MemMeter("cpu")
    m.update()
    assert m.peak == 0 and m.peak_gb == 0.0
    line = port_utils.ProgressMeter(4, [m, port_utils.DurationMeter()]).display(1)
    assert "mem 0.00GB" in line and " t " in line


def test_tensorboard_jsonl_fallback_equals_jax(tmp_path, monkeypatch):
    # without the tensorboard package both fall back to scalars.jsonl
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lines = []
    for name, utils in (("port", port_utils), ("jax", jax_utils)):
        d = tmp_path / name
        tb = utils.TensorBoardLogger(str(d))
        assert tb._writer is None
        tb.log("loss", 1.5, step=0)
        tb.log_dict({"a": 1.0, "b": "skip-me", "c": np.float32(2.5), "d": torch.tensor(0.25)},
                    step=1, prefix="val/")
        tb.flush()
        tb.close()
        assert os.listdir(d) == ["scalars.jsonl"]
        lines.append((d / "scalars.jsonl").read_text())
    assert lines[0] == lines[1] and lines[0].count("\n") == 4


def test_tensorboard_writer_when_available(tmp_path):
    pytest.importorskip("tensorboard")
    tb = port_utils.TensorBoardLogger(str(tmp_path))
    tb.log("loss", 1.5, step=0)
    tb.close()
    assert any("events" in f for f in os.listdir(tmp_path))


def test_setup_logging_handlers(tmp_path):
    log = port_utils.setup_logging(str(tmp_path), name="sam3_lora_tpu_torch.test")
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in (tmp_path / "train.log").read_text()
    assert len(log.handlers) == 2 and not log.propagate
    log = port_utils.setup_logging(None, level=logging.WARNING, name="sam3_lora_tpu_torch.test")
    assert len(log.handlers) == 1 and log.level == logging.WARNING


def test_trace_span_in_profiler_events_and_capture_trace(tmp_path):
    x = torch.ones(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port_utils.trace_span("encoder"):
            (x @ x).sum()
    assert "encoder" in {e.key for e in prof.key_averages()}
    with port_utils.trace_span("no profiler"):
        assert float((x @ x).sum()) == 64.0 ** 3
    with port_utils.capture_trace(str(tmp_path)):
        with port_utils.trace_span("step"):
            (x @ x).sum()
    files = os.listdir(tmp_path)
    assert files and all(f.endswith(".json") for f in files)
    assert '"step"' in (tmp_path / files[0]).read_text()
