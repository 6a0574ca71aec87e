"""The port's spans and counters (``utils/logging.py``): ``trace_span`` records
nothing without a profiler and nests by name under one, the counters count
in both cases, and one tiny-config update, one ``predict`` and one
``set_image`` with two ``set_text_prompt`` each give the span tree of their
stages once a unit, with ``host_syncs`` and ``d2h_bytes`` what their routed
transfers imply. ``measure.device_intervals`` leaves the host's annotations
out of a step's device time."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from sam3_lora_tpu_torch import measure
from sam3_lora_tpu_torch.config import LoRAConfig, TrainConfig, tiny_model_config
from sam3_lora_tpu_torch.processor import Sam3Processor
from sam3_lora_tpu_torch.train.data import DataLoader
from sam3_lora_tpu_torch.train.trainer import Trainer
from sam3_lora_tpu_torch.utils import logging as tl

LORA = LoRAConfig(target_modules=("qkv", "fc1"))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _traced(fn):
    """(fn's result, the spans it recorded, the counters' increments, the
    profiler's names) of one call of ``fn`` under the CPU profiler."""
    spans0, counts0 = (len(x) for x in tl.recorded())
    c0 = tl.counters()
    with _cpu_profile() as prof:
        out = fn()
    spans, counts = tl.recorded()
    c1 = tl.counters()
    delta = {k: c1[k] - c0.get(k, 0) for k in c1 if c1[k] != c0.get(k, 0)}
    names = {e.name for e in prof.events()}
    return out, spans[spans0:], delta, counts[counts0:], names


def _parent(span, spans):
    """The smallest other recorded span that holds ``span``."""
    holders = [s for s in spans if s is not span and s[1] <= span[1] and span[2] <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


def _tree(spans):
    """{(name, parent name): times}."""
    out = {}
    for s in spans:
        key = (s[0], _parent(s, spans))
        out[key] = out.get(key, 0) + 1
    return out


def test_trace_span_records_nothing_without_a_profiler_and_counters_count():
    before = [len(x) for x in tl.recorded()]
    c0 = tl.counters()
    with tl.trace_span("sam3.outer"):
        with tl.trace_span("sam3.inner"):
            tl.count("test_events", 2)
    assert [len(x) for x in tl.recorded()] == before
    assert tl.counters()["test_events"] == c0.get("test_events", 0) + 2
    assert not torch.autograd._profiler_enabled()


def test_trace_span_nests_by_name_under_a_profiler():
    def run():
        with tl.trace_span("sam3.outer"):
            with tl.trace_span("sam3.inner"):
                tl.count("test_events")
            with tl.trace_span("sam3.inner"):
                pass

    _, spans, delta, counts, names = _traced(run)
    assert {"sam3.outer", "sam3.inner"} <= names
    assert _tree(spans) == {("sam3.outer", None): 1, ("sam3.inner", "sam3.outer"): 2}
    assert delta == {"test_events": 1}
    assert [(n, k) for n, _, k in counts] == [("test_events", 1)]
    outer = [s for s in spans if s[0] == "sam3.outer"][0]
    assert outer[1] <= counts[0][1] <= outer[2]


def test_to_host_and_to_device_count_and_span():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    (host, dev), spans, delta, _, names = _traced(
        lambda: (tl.to_host(x, "probe"), tl.to_device(x, "cpu", "probe_up")))
    assert torch.equal(host, x) and torch.equal(dev, x)
    assert delta == {"host_syncs": 2, "d2h_bytes": 48}
    assert [s[0] for s in spans] == ["sam3.sync.probe", "sam3.sync.probe_up"]
    assert {"sam3.sync.probe", "sam3.sync.probe_up"} <= names
    # an empty tensor moves no byte and waits for nothing
    (host, dev), spans, delta, _, _ = _traced(
        lambda: (tl.to_host(x[:0], "probe"), tl.to_device(x[:0], "cpu", "probe_up")))
    assert host.shape == dev.shape == (0, 4) and spans == [] and delta == {}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    cfg = tiny_model_config()
    tcfg = TrainConfig(batch_size=2, num_epochs=1, warmup_steps=0, num_workers=1, seed=0,
                       output_dir=str(tmp_path_factory.mktemp("out")), device_prefetch=0)
    tr = Trainer(cfg, LORA, tcfg, device="cpu")
    loader = DataLoader(chip_smoke.SyntheticSamples(cfg, 4, 0), 2, shuffle=False, num_workers=1)
    tr.setup(steps_per_epoch=len(loader))
    tr.train_step(next(loader.epoch(0)))  # the first step imports and builds what it needs
    return tr, loader


def test_one_update_gives_the_training_span_tree(trainer):
    tr, loader = trainer
    cfg = tr.mcfg

    def update():
        batch = next(loader.epoch(1))
        tr.train_step(batch)
        return batch

    batch, spans, delta, _, names = _traced(update)
    assert _tree(spans) == {
        ("sam3.data.wait", None): 1,
        ("sam3.train_step", None): 1,
        ("sam3.forward", "sam3.train_step"): 1,
        ("sam3.match", "sam3.forward"): 1,
        ("sam3.sync.match_cost", "sam3.match"): 1,
        ("sam3.sync.match_idx", "sam3.match"): 1,
        ("sam3.loss", "sam3.train_step"): 1,
        ("sam3.backward", "sam3.train_step"): 1,
        ("sam3.update", "sam3.train_step"): 1,
    }
    assert {n for n, _, _ in spans} <= names
    # the cost of every matching problem and the targets' validity, fp32
    problems = 2 * cfg.dec_layers - 1 if cfg.dac else cfg.dec_layers
    b, t = batch.targets.valid.shape
    assert delta == {"host_syncs": 2, "d2h_bytes": problems * b * t * (cfg.num_queries + 1) * 4}


@pytest.fixture(scope="module")
def processor():
    proc = Sam3Processor(tiny_model_config(), LORA, device="cpu")
    return proc


def test_one_predict_gives_the_serving_span_tree(processor):
    eng = processor.engine
    image = np.random.RandomState(0).randint(0, 256, (90, 120, 3), np.uint8)
    prompts = ["crack", "hole"]
    eng.predict(image, prompts, threshold=0.0)  # the resize taps reach the device once
    res, spans, delta, _, names = _traced(lambda: eng.predict(image, prompts, threshold=0.0))
    n = len(prompts)
    assert _tree(spans) == {
        ("sam3.predict", None): 1,
        ("sam3.preprocess", "sam3.predict"): 1,
        ("sam3.sync.image", "sam3.preprocess"): 1,
        ("sam3.sync.tokens", "sam3.preprocess"): 1,
        ("sam3.forward", "sam3.predict"): 1,
        ("sam3.post", "sam3.predict"): 1,
        ("sam3.sync.scores", "sam3.post"): 1,
        ("sam3.sync.boxes", "sam3.post"): 1,
        ("sam3.sync.keep", "sam3.post"): n,
        ("sam3.sync.masks", "sam3.post"): n,
    }
    assert {n for n, _, _ in spans} <= names
    q = eng.cfg.num_queries
    assert all(res[i]["num_detections"] == q for i in range(n))  # threshold 0 keeps every query
    masks = sum(res[i]["masks"].nbytes for i in range(n))
    assert delta == {"host_syncs": 4 + 2 * n, "d2h_bytes": n * q * 4 + n * q * 4 * 4 + masks}


def test_set_image_and_two_prompts_give_the_processor_span_tree(processor):
    image = np.random.RandomState(1).randint(0, 256, (90, 120, 3), np.uint8)
    processor.set_image(image)  # the resize taps reach the device once

    def session():
        processor.set_image(image)
        return [processor.set_text_prompt(p, threshold=0.0) for p in ("crack", "hole")]

    res, spans, delta, _, names = _traced(session)
    assert _tree(spans) == {
        ("sam3.set_image", None): 1,
        ("sam3.preprocess", "sam3.set_image"): 1,
        ("sam3.sync.image", "sam3.preprocess"): 1,
        ("sam3.forward", "sam3.set_image"): 1,
        ("sam3.set_text_prompt", None): 2,
        ("sam3.preprocess", "sam3.set_text_prompt"): 2,
        ("sam3.sync.tokens", "sam3.preprocess"): 2,
        ("sam3.forward", "sam3.set_text_prompt"): 2,
        ("sam3.post", "sam3.set_text_prompt"): 2,
        ("sam3.sync.presence", "sam3.post"): 2,
        ("sam3.sync.scores", "sam3.post"): 2,
        ("sam3.sync.boxes", "sam3.post"): 2,
        ("sam3.sync.keep", "sam3.post"): 2,
        ("sam3.sync.masks", "sam3.post"): 2,
    }
    assert {n for n, _, _ in spans} <= names
    q = processor.cfg.num_queries
    masks = sum(r["masks_lowres"].nbytes for r in res)
    assert delta == {"host_syncs": 1 + 2 * 6, "d2h_bytes": 2 * (4 + q * 4 + q * 4 * 4) + masks}


def test_device_intervals_leave_host_annotations_out():
    cuda, cpu = "cuda", "cpu"

    def ev(name, kind, a, b):
        return types.SimpleNamespace(name=name, device_type=kind,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev("sam3.forward", cpu, 0, 100), ev("aten::mm", cpu, 10, 20),
              ev("sam3.forward", cuda, 5, 95),  # the range's copy on the device's timeline
              ev("gemm_kernel", cuda, 30, 40), ev("Memcpy DtoH", cuda, 50, 55)]
    assert measure.device_intervals(events, cuda) == [(30, 40, "gemm_kernel"),
                                                      (50, 55, "Memcpy DtoH")]
    assert measure.covered(measure.device_intervals(events, cuda)) == 15


def test_span_cost_reads_each_cost_and_records_the_traced_spans():
    spans0 = len(tl.recorded()[0])
    cost = measure.span_cost_us(n=200, n_traced=50)
    assert set(cost) == {"off", "count", "record_function_off", "on"}  # no card: no NVTX row
    assert all(v > 0 for v in cost.values())
    assert [s[0] for s in tl.recorded()[0][spans0:]] == ["sam3.cost"] * 50
