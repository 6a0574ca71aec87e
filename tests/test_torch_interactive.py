"""The port's ``interactive.py`` (a copy) against the JAX package's: the
error-driven box sampler on seeded predictions and ground truth (misses,
false positives, prompts already given, jitter), and the multi-step session
on the same stubbed processor outputs (a processor whose groundings depend
on the prompts it is given). Every prompt, label, return value and stage
output is equal (tolerance 0: the same numpy arithmetic). Then
``interactive_ground`` on the port's tiny processor (CPU): the backbone runs
once, and every stage grounds the cache with the grown prompts."""

import collections
import copy

import numpy as np
import pytest

from sam3_lora_tpu import interactive as jint
from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch import interactive as tint
from sam3_lora_tpu_torch.processor import Sam3Processor


class StubProcessor:
    """``set_image`` / ``set_text_prompt`` with seeded outputs that depend
    on the call count and on the box prompts (xyxy boxes at the original
    size, scores in [0, 1])."""

    def __init__(self, seed: int, max_prompt_boxes: int = 3):
        self.cfg = type("Cfg", (), {"max_prompt_boxes": max_prompt_boxes})()
        self.seed, self.calls, self.images = seed, [], 0
        self._state = None

    def set_image(self, image):
        self.images += 1
        self._state = {"orig_size": tuple(np.asarray(image).shape[:2])}
        return self

    def set_text_prompt(self, prompt, boxes=None, box_labels=None, threshold=None):
        self.calls.append((prompt, None if boxes is None else np.asarray(boxes).copy(),
                           None if box_labels is None else list(box_labels), threshold))
        rng = np.random.RandomState(self.seed + 7 * len(self.calls))
        n = rng.randint(1, 6)
        h, w = self._state["orig_size"]
        xy = np.sort(rng.rand(n, 2, 2), axis=1).reshape(n, 4)[:, [0, 2, 1, 3]]
        boxes_out = xy * np.array([w, h, w, h], np.float32)
        if boxes is not None:  # the prompts pull the first detections onto themselves
            b = np.asarray(boxes, np.float32)
            k = min(n, len(b))
            cx, cy, bw, bh = b[:k].T
            boxes_out[:k] = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                                      (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
        return {"prompt": prompt, "scores": rng.rand(n).astype(np.float32),
                "boxes": boxes_out.astype(np.float32), "num_detections": n}


def _boxes(rng, n):
    c = rng.rand(n, 2) * 0.6 + 0.2
    s = rng.rand(n, 2) * 0.3 + 0.05
    return np.concatenate([c, s], -1).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_sampler_matches_jax(seed, jitter):
    rng = np.random.RandomState(seed)
    preds, gts = _boxes(rng, rng.randint(0, 7)), _boxes(rng, rng.randint(0, 5))
    preds[: len(gts) // 2] = gts[: len(preds[: len(gts) // 2])]  # some hits
    scores = rng.rand(len(preds)).astype(np.float32)
    prompt_boxes = [b for b in _boxes(rng, 2)]
    prompt_labels = [1, 0]
    kw = dict(max_new_positives=2, max_new_negatives=2, jitter=jitter)
    out = {}
    for name, mod in (("jax", jint), ("port", tint)):
        pb, pl = copy.deepcopy(prompt_boxes), list(prompt_labels)
        added = mod.ErrorDrivenBoxSampler(**kw).sample(preds, scores, gts, pb, pl,
                                                       rng=np.random.RandomState(seed))
        out[name] = (added, np.asarray(pb), pl)
    assert out["port"][0] == out["jax"][0] and out["port"][2] == out["jax"][2]
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_session_matches_jax_on_stubbed_outputs(steps):
    image = np.zeros((40, 60, 3), np.uint8)
    gts = _boxes(np.random.RandomState(9), 4)
    stages, stubs = {}, {}
    for name, mod in (("jax", jint), ("port", tint)):
        stubs[name] = StubProcessor(seed=3)
        sampler = mod.ErrorDrivenBoxSampler(max_new_positives=1, max_new_negatives=1, jitter=0.05)
        stages[name] = mod.interactive_ground(stubs[name], image, "crack", gts,
                                              num_interactive_steps=steps, sampler=sampler,
                                              threshold=0.3)
    assert len(stages["port"]) == len(stages["jax"]) >= 1
    for got, want in zip(stages["port"], stages["jax"]):
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "prompt_boxes":
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
            elif isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k
    assert stubs["port"].images == stubs["jax"].images == 1
    for a, b in zip(stubs["port"].calls, stubs["jax"].calls):
        assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3]
        np.testing.assert_array_equal(a[1] if a[1] is not None else np.zeros(0),
                                      b[1] if b[1] is not None else np.zeros(0))


def test_refine_before_step_raises():
    sess = tint.InteractiveSession(StubProcessor(0), "crack", np.zeros((0, 4)))
    with pytest.raises(RuntimeError, match="step"):
        sess.refine()


def test_interactive_ground_on_the_ports_processor(monkeypatch):
    proc = Sam3Processor(tc.tiny_model_config(), device="cpu")
    calls = collections.Counter()
    orig = proc.model.backbone_image

    def spy(*a, **k):
        calls["backbone_image"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(proc.model, "backbone_image", spy)
    image = np.random.RandomState(5).randint(0, 256, (40, 60, 3)).astype(np.uint8)
    gts = np.array([[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.2, 0.2]], np.float32)
    stages = tint.interactive_ground(proc, image, "crack", gts, num_interactive_steps=2,
                                     threshold=0.0)
    assert calls["backbone_image"] == 1
    assert 1 <= len(stages) <= 3
    for i, st in enumerate(stages):
        assert np.isfinite(st["scores"]).all() and np.isfinite(st["boxes"]).all()
        assert len(st["prompt_boxes"]) == len(st["prompt_labels"])
        if i:
            assert len(st["prompt_boxes"]) > len(stages[i - 1]["prompt_boxes"])
