"""The port's agent tier against the JAX package's: ``viz.py``,
``agent_helpers.py``, ``agent_tools.py`` and ``agent.py`` are copies (syntax
trees equal without the docstrings), the prompt corpus is copied byte for
byte and ``load_system_prompt`` reads the port's own; the copies' outputs
equal the originals' on the same inputs (the viz renderings, the helpers'
geometry, a scripted tool-agent run over a stub processor); and
chip_smoke's agent drive runs on the CPU over the port's tiny
``Sam3Processor`` with the checks of the chip phase: ``set_image`` runs the
ViT's kernel entries once, each ``segment_phrase`` the fusion encoder's
alone, the duplicate phrase is rejected, the selected masks are those of
the processor's own ``set_text_prompt`` output, re-indexed as the copy's
rule says, with their boxes and scores, and the rule-based refiner runs
its 4 rounds."""

import filecmp
import json
import os

import numpy as np
import pytest

import chip_smoke
from sam3_lora_tpu import agent as jagent
from sam3_lora_tpu import agent_helpers as jhelpers
from sam3_lora_tpu import agent_tools as jtools
from sam3_lora_tpu import viz as jviz
from sam3_lora_tpu_torch import agent as tagent
from sam3_lora_tpu_torch import agent_helpers as thelpers
from sam3_lora_tpu_torch import agent_tools as ttools
from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch import viz as tviz
from sam3_lora_tpu_torch.processor import Sam3Processor

from torch_port_helpers import code_of, count_card_entries

COPIES = [(jviz, tviz), (jhelpers, thelpers), (jtools, ttools), (jagent, tagent)]
PROMPTS = ("grounding_agent", "mask_check")


@pytest.mark.parametrize("pair", COPIES, ids=[j.__name__.split(".")[-1] for j, _ in COPIES])
def test_copy_has_the_jax_code(pair):
    jmod, tmod = pair
    assert code_of(jmod) == code_of(tmod)


@pytest.mark.parametrize("name", PROMPTS)
def test_prompt_corpus_is_copied(name):
    rel = os.path.join("assets", "agent_prompts", f"{name}.txt")
    jpath = os.path.join(os.path.dirname(jtools.__file__), rel)
    tpath = os.path.join(os.path.dirname(ttools.__file__), rel)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    text = ttools.load_system_prompt(name)
    assert text == jtools.load_system_prompt(name) and text
    with pytest.raises(FileNotFoundError):
        ttools.load_system_prompt("nonsense")


def test_viz_renderings_equal_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    masks = [rng.rand(30, 40) > 0.7, rng.rand(15, 20) > 0.5]  # the second at low resolution
    boxes = [[2.0, 3.0, 20.0, 25.0], [10.5, 1.0, 39.0, 12.0]]
    for name, args, kw in (("overlay_masks", (img, masks), {}),
                           ("draw_boxes", (img, boxes), dict(labels=["a", "b"], scores=[0.9, 0.4])),
                           ("draw_set_of_marks", (img, masks[:1]), {}),
                           ("side_by_side", ([img, img[:20]],), {})):
        np.testing.assert_array_equal(getattr(tviz, name)(*args, **kw),
                                      getattr(jviz, name)(*args, **kw), err_msg=name)
    (crop, win), (want, want_win) = (v.zoom_to_box(img, boxes[0], out_size=16) for v in (tviz, jviz))
    np.testing.assert_array_equal(crop, want)
    assert win == want_win


def test_agent_helpers_equal_jax():
    rng = np.random.RandomState(1)
    a = np.sort(rng.uniform(0, 50, (5, 4)).reshape(5, 2, 2), axis=1).reshape(5, 4)
    b = np.sort(rng.uniform(0, 50, (3, 4)).reshape(3, 2, 2), axis=1).reshape(3, 4)
    for name in ("pairwise_iou", "pairwise_ioa"):
        np.testing.assert_array_equal(getattr(thelpers, name)(a, b), getattr(jhelpers, name)(a, b))
    rot = np.concatenate([a[:, :2] + 5, a[:, 2:] - a[:, :2] + 1, rng.uniform(-90, 90, (5, 1))], 1)
    np.testing.assert_array_equal(thelpers.pairwise_iou_rotated(rot, rot[:2]),
                                  jhelpers.pairwise_iou_rotated(rot, rot[:2]))
    masks = rng.rand(4, 16, 16) > 0.5
    np.testing.assert_array_equal(thelpers.mask_iom(masks, masks), jhelpers.mask_iom(masks, masks))


class StubProcessor:
    """A processor of fixed numpy outputs: ``n`` low-resolution masks."""

    def __init__(self, n: int, seed: int = 2):
        rng = np.random.RandomState(seed)
        self.out = {"masks_lowres": rng.rand(n, 12, 12) > 0.6, "num_detections": n,
                    "boxes": np.sort(rng.uniform(0, 40, (n, 2, 2)), axis=1).reshape(n, 4),
                    "scores": rng.rand(n), "presence": 0.7}

    def set_image(self, image):
        return self

    def set_text_prompt(self, prompt, threshold=0.5):
        return dict(self.out, prompt=prompt)


def script(n: int):
    return ([chip_smoke.tool_turn("segment_phrase", text_prompt="crack")] * 2
            + [chip_smoke.tool_turn("segment_phrase", text_prompt="wall"),
               chip_smoke.tool_turn("examine_each_mask")]
            + [f"<verdict>{'Reject' if i % 2 else 'Accept'}</verdict>" for i in range(n)]
            + [chip_smoke.tool_turn("select_masks_and_return", final_answer_masks=[2, 1, 99])])


def test_tool_agent_equals_jax_over_a_stub_processor():
    img = np.random.RandomState(3).randint(0, 256, (30, 40, 3)).astype(np.uint8)
    runs = [tools.tool_agent_inference(StubProcessor(5), img, "q", tools.ScriptedLLM(script(5)))
            for tools in (jtools, ttools)]
    want, got = runs
    assert got.used_prompts == want.used_prompts == ["crack", "wall"]
    assert (got.boxes, got.scores, got.no_mask, got.rounds) == \
        (want.boxes, want.scores, want.no_mask, want.rounds)
    assert len(got.masks) == 2 and all(np.array_equal(a, b) for a, b in zip(got.masks, want.masks))
    strip = lambda t: [{k: v for k, v in m.items() if k != "image"} for m in t]  # noqa: E731
    assert json.dumps(strip(got.transcript)) == json.dumps(strip(want.transcript))
    for m, w in zip(got.transcript, want.transcript):
        assert ("image" in m) == ("image" in w)
        if "image" in m:
            np.testing.assert_array_equal(m["image"], w["image"])
    refined = [a.agent_inference(StubProcessor(0), img, "the cracks", a.RuleBasedRefiner(),
                                 threshold=0.5) for a in (jagent, tagent)]
    assert refined[1].transcript == refined[0].transcript and refined[1].rounds == 4


@pytest.fixture
def counted(monkeypatch):
    count_card_entries(monkeypatch)
    chip_smoke.reset_counts()
    yield
    chip_smoke.reset_counts()


def test_chip_smoke_agent_drive_on_the_cpu(counted):
    """chip_smoke's agent phase at the tiny config, on the CPU: its drive
    and every check it makes on the card."""
    cfg = tc.tiny_model_config(d_model=16, enc_heads=2, dec_heads=2, flash_attention_min_seq=16)
    proc = Sam3Processor(cfg, chip_smoke.LORA, device="cpu")
    image = np.random.RandomState(4).randint(0, 256, (45, 60, 3)).astype(np.uint8)
    got = chip_smoke.agent_drive(proc, image, "cpu")
    chip_smoke.check_agent("agent", cfg, image, got)
    assert got["n"] == chip_smoke.AGENT_MASKS and got["refined"].phrase == "objects"
    assert "set_image" not in vars(proc) and "set_text_prompt" not in vars(proc)
    assert got["result"].masks[0].shape == (45, 60)
