"""The port's ``Sam3Processor`` (``sam3_lora_tpu_torch/processor.py``) against
the JAX package's, on the tiny config with the same seeded weights (a JAX
init filled from numpy, through the weight bridge) and the same uint8 image.

The JAX processor's results are stored in ``tests/data/torch_ref_processor.npz``
with the parameter shapes they were drawn at, so the fast test needs no JAX
compile; ``test_reference_is_current`` (slow: it jits the JAX processor)
recomputes them and holds the port against the live JAX processor too.
Rewrite the file after a change that moves the JAX side or the tiny config:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_processor.py``.

Tolerance 2e-4 absolute and relative, as ``test_torch_slice.py::
test_predict_matches_jax`` (fp32 on both sides, sums in another order):
scores, presence, boxes (in pixels, so 2e-4 times the image side), and the
low-resolution masks equal but for pixels whose probability lies within
2e-4 of the 0.5 threshold. Text prompts, and a text prompt with box
prompts (more boxes than slots, a negative label). Also: ``set_text_prompt``
runs no backbone; each call's kernel entries, counted on the CPU through
the card's routes, equal ``chip_smoke``'s ``set_image_launches`` and
``prompt_launches``, bf16 routes and the int8 tier with K5.

Mask prompts (``geo_mask_prompts=True``): a 40x60 mask prompt alone and with
box prompts against the JAX processor with the option on, at the same
tolerance; the JAX results are stored in ``tests/data/
torch_ref_mask_prompt.npz`` (``test_mask_prompt_reference_is_current``, slow,
recomputes them; the ``__main__`` below rewrites both files). With the option
off both processors refuse a mask prompt."""

import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import chip_smoke
from sam3_lora_tpu import processor as jax_processor
from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models.geometry import GeoPrompt as JGeoPrompt
from sam3_lora_tpu.models.sam3_image import Batch as JBatch
from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.ops import attention_kernel as ak
from sam3_lora_tpu_torch.ops import gemm_int8
from sam3_lora_tpu_torch.ops import window_attention as wa
from sam3_lora_tpu_torch.processor import Sam3Processor
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import fill_params, param_specs

TOL = 2e-4
TARGETS = ("qkv", "fc1", "fc2", "linear1", "linear2")
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS)  # the JAX package's
TLORA = tc.LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS)  # the port's
IMAGE = np.random.RandomState(5).randint(0, 256, (40, 60, 3)).astype(np.uint8)
BOXES = np.array([[0.5, 0.5, 0.4, 0.3], [0.3, 0.6, 0.2, 0.5], [0.7, 0.2, 0.2, 0.1]], np.float32)
CALLS = (  # (prompt, box prompts, their labels, threshold)
    ("crack", None, None, 0.0),
    ("a small dog", None, None, 0.2),
    ("crack", BOXES, [1, 0, 1], 0.0),
)


REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_processor.npz")
KEYS = ("scores", "boxes", "masks_lowres", "presence", "num_detections")


def jax_reference():
    """-> (parameter shapes in draw order, the JAX processor's results of
    CALLS on IMAGE with weights filled from numpy seed 0)."""
    cfg = tiny_model_config()
    jm = build_jax(cfg, lora=LORA)
    r = cfg.img_size
    jb = JBatch(images=jnp.zeros((1, 3, r, r)), token_ids=jnp.zeros((1, cfg.text_context_length),
                                                                     jnp.int32),
                img_ids=jnp.zeros((1,), jnp.int32), geo=JGeoPrompt.empty(1, cfg.max_prompt_boxes))
    specs = param_specs(jm, jb, train=False)
    flat = fill_params(specs)
    params = traverse_util.unflatten_dict({path: jnp.asarray(flat[".".join(path)])
                                           for path, _ in specs})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_processor, "init_model", lambda model, key: params)
        ref = jax_processor.Sam3Processor(cfg, LORA)
    ref.set_image(IMAGE)
    results = [ref.set_text_prompt(p, boxes=b, box_labels=lab, threshold=t)
               for p, b, lab, t in CALLS]
    return [[".".join(path), list(shape)] for path, shape in specs], results


def write_reference(path: str = REF) -> str:
    specs, results = jax_reference()
    arrays = {f"{i}/{k}": np.asarray(res[k]) for i, res in enumerate(results) for k in KEYS}
    np.savez(path, params=json.dumps(specs), **arrays)
    return path


def load_reference(path: str = REF):
    with np.load(path) as data:
        specs = [(tuple(name.split(".")), tuple(shape))
                 for name, shape in json.loads(str(data["params"]))]
        results = [{k: data[f"{i}/{k}"] for k in KEYS} for i in range(len(CALLS))]
    return specs, results


def port_processor(specs):
    proc = Sam3Processor(tc.tiny_model_config(), TLORA, device="cpu")
    load_jax_params(proc.model, fill_params(specs))
    return proc


def check_against(proc, want):
    """The port's results of CALLS against ``want`` (the JAX processor's)."""
    proc.set_image(IMAGE)
    assert proc._state["orig_size"] == (40, 60)
    for (prompt, boxes, labels, thr), ref in zip(CALLS, want):
        got = proc.set_text_prompt(prompt, boxes=boxes, box_labels=labels, threshold=thr)
        assert list(got) == ["prompt", *KEYS] and got["prompt"] == prompt
        assert got["num_detections"] == int(ref["num_detections"]) > 0
        np.testing.assert_allclose(got["presence"], ref["presence"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=TOL, atol=TOL * 60)
        # the masks: equal wherever the probability is not at the threshold
        scores, _, _, probs = proc.ground(prompt, proc.geo_prompt(boxes, labels))
        kept = scores[0].numpy() * got["presence"] > thr
        sure = ((probs[0] - 0.5).abs() > TOL).numpy()[kept]
        assert got["masks_lowres"].shape == ref["masks_lowres"].shape
        np.testing.assert_array_equal(got["masks_lowres"][sure], ref["masks_lowres"][sure])


@pytest.fixture(scope="module")
def pair():
    """(the stored JAX results of CALLS, the port's processor on the same weights)."""
    specs, want = load_reference()
    return want, port_processor(specs)


def test_processor_matches_jax(pair):
    want, proc = pair
    check_against(proc, want)


def test_reference_is_current():
    """The stored reference against the live JAX processor, and the port
    against the live one."""
    specs, live = jax_reference()
    stored_specs, stored = load_reference()
    assert [[".".join(p), list(s)] for p, s in stored_specs] == specs
    for got, want in zip(stored, live):
        for k in KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    check_against(port_processor(stored_specs), live)


def test_box_prompt_changes_the_grounding(pair):
    _, proc = pair
    proc.set_image(IMAGE)
    text = proc.set_text_prompt("crack", threshold=0.0)
    boxed = proc.set_text_prompt("crack", boxes=BOXES[:1], threshold=0.0)
    assert text["num_detections"] == boxed["num_detections"] == proc.cfg.num_queries
    assert not np.allclose(text["scores"], boxed["scores"])
    geo = proc.add_geometric_prompt("crack", BOXES[:1], labels=[1])
    same = proc.set_text_prompt("crack", boxes=BOXES[:1], threshold=proc.threshold)
    assert geo["num_detections"] == same["num_detections"]
    np.testing.assert_array_equal(geo["scores"], same["scores"])


def test_set_text_prompt_runs_no_backbone(pair, monkeypatch):
    _, proc = pair
    proc.set_image(IMAGE)
    calls = collections.Counter()
    orig = proc.model.backbone_image

    def spy(*a, **k):
        calls["backbone_image"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(proc.model, "backbone_image", spy)
    state = proc._state
    proc.set_text_prompt("crack")
    proc.add_geometric_prompt("wall", BOXES[:2])
    assert calls["backbone_image"] == 0 and proc._state is state
    proc.set_image(IMAGE)
    assert calls["backbone_image"] == 1


MASK = np.zeros((40, 60), np.float32)
MASK[8:30, 10:45] = 1.0
MASK_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_ref_mask_prompt.npz")
MASK_CALLS = (("crack", None, None), ("crack", BOXES[:2], [1, 0]))


def jax_mask_prompt_reference():
    """-> (parameter shapes, the JAX processor's results of MASK_CALLS with
    MASK as the mask prompt), ``geo_mask_prompts=True``, weights from numpy
    seed 0."""
    cfg = tiny_model_config(geo_mask_prompts=True)
    jm = build_jax(cfg, lora=LORA)
    r = cfg.img_size
    geo = JGeoPrompt.empty(1, cfg.max_prompt_boxes).replace(
        mask_embeddings=jnp.zeros((1, 1, r, r)), mask_mask=jnp.ones((1, 1), bool),
        mask_labels=jnp.ones((1, 1), jnp.int32))
    jb = JBatch(images=jnp.zeros((1, 3, r, r)), token_ids=jnp.zeros((1, cfg.text_context_length),
                                                                     jnp.int32),
                img_ids=jnp.zeros((1,), jnp.int32), geo=geo)
    specs = param_specs(jm, jb, train=False)
    flat = fill_params(specs)
    params = traverse_util.unflatten_dict({path: jnp.asarray(flat[".".join(path)])
                                           for path, _ in specs})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_processor, "init_model", lambda model, key: params)
        ref = jax_processor.Sam3Processor(cfg, LORA)
    ref.set_image(IMAGE)
    results = [ref.set_text_prompt(p, boxes=b, box_labels=lab, threshold=0.0, mask_prompt=MASK)
               for p, b, lab in MASK_CALLS]
    return [[".".join(path), list(shape)] for path, shape in specs], results


def write_mask_prompt_reference(path: str = MASK_REF) -> str:
    specs, results = jax_mask_prompt_reference()
    arrays = {f"{i}/{k}": np.asarray(res[k]) for i, res in enumerate(results) for k in KEYS}
    np.savez(path, params=json.dumps(specs), **arrays)
    return path


def load_mask_prompt_reference(path: str = MASK_REF):
    with np.load(path) as data:
        specs = [(tuple(name.split(".")), tuple(shape))
                 for name, shape in json.loads(str(data["params"]))]
        results = [{k: data[f"{i}/{k}"] for k in KEYS} for i in range(len(MASK_CALLS))]
    return specs, results


def check_mask_prompts(specs, want):
    proc = Sam3Processor(tc.tiny_model_config(geo_mask_prompts=True), TLORA, device="cpu")
    load_jax_params(proc.model, fill_params(specs))
    proc.set_image(IMAGE)
    for (prompt, boxes, labels), ref in zip(MASK_CALLS, want):
        got = proc.set_text_prompt(prompt, boxes=boxes, box_labels=labels, threshold=0.0,
                                   mask_prompt=MASK)
        assert got["num_detections"] == int(ref["num_detections"]) > 0
        np.testing.assert_allclose(got["presence"], ref["presence"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=TOL, atol=TOL * 60)
    # the mask prompt moves the grounding, and its h*w tokens join the prompt
    plain = proc.set_text_prompt("crack", threshold=0.0)
    masked = proc.set_text_prompt("crack", threshold=0.0, mask_prompt=MASK)
    assert not np.allclose(plain["scores"], masked["scores"])
    geo = proc.geo_prompt(None)
    geo.mask_embeddings = torch.from_numpy(MASK)[None, None]
    geo.mask_mask = torch.zeros((1, 1), dtype=torch.bool)
    geo.mask_labels = torch.ones((1, 1), dtype=torch.long)
    feats = proc._state["feats"][-1]
    tokens = feats.flatten(2).transpose(1, 2)
    seq, mask = proc.model.geometry_encoder(geo, tokens, tokens, feats.shape[-2:])
    fh = proc.cfg.feat_size
    assert seq.shape[1] == mask.shape[1] == proc.cfg.max_prompt_boxes + 1 + fh * fh
    assert not mask[0, -fh * fh:].any()


def test_processor_needs_an_image_and_takes_mask_prompts_with_the_option():
    """No image: refused. A mask prompt with ``geo_mask_prompts`` off:
    refused, as JAX's processor refuses it; with it on: the JAX processor's
    results (the stored reference)."""
    proc = Sam3Processor(tc.tiny_model_config(), device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        proc.set_text_prompt("crack")
    proc.set_image(IMAGE)
    with pytest.raises(ValueError, match="geo_mask_prompts"):
        proc.set_text_prompt("crack", mask_prompt=np.ones((8, 8), np.float32))
    check_mask_prompts(*load_mask_prompt_reference())


def test_mask_prompt_reference_is_current():
    specs, live = jax_mask_prompt_reference()
    stored_specs, stored = load_mask_prompt_reference()
    assert [[".".join(p), list(s)] for p, s in stored_specs] == specs
    for got, want in zip(stored, live):
        for k in KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    check_mask_prompts([(tuple(n.split(".")), tuple(sh)) for n, sh in specs], live)


@pytest.fixture
def launches(monkeypatch):
    """Each kernel entry's forward calls on the CPU (through the card's
    window routes), counted on the counters chip_smoke reads."""
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)
    orig = ak._forward

    def forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse):
        entry.launches += 1
        ak.rope_cuda.launches += cos is not None
        return orig(entry, q, k, v, scale, head_dim, cos, sin, with_lse)

    monkeypatch.setattr(ak, "_forward", forward)
    for entry in (gemm_int8.int8_gemm_wres, gemm_int8.int8_lora_gemm_wres):
        plain = getattr(gemm_int8, entry.__name__ + "_plain")

        def counted(*a, _entry=entry, _plain=plain, **k):
            _entry.launches += 1
            return _plain(*a, **k)

        monkeypatch.setattr(gemm_int8, entry.__name__, counted)
    chip_smoke.reset_counts()
    yield
    chip_smoke.reset_counts()


@pytest.mark.parametrize("int8", [False, True])
def test_launch_counts_match_chip_smoke(launches, monkeypatch, int8):
    """A CPU rehearsal of chip_smoke's processor counts: set_image runs the
    ViT's K1/K2 (and K5/K4 in the int8 tier), each prompt K3 and the text
    encoder's K4 and nothing of the ViT. The int8 gate covers the ViT and
    the text encoder alone, as the full config's does."""
    monkeypatch.setattr(gemm_int8, "GEMM_LORA_FUSED", int8)
    cfg = tc.tiny_model_config(d_model=16, enc_heads=2, dec_heads=2, flash_attention_min_seq=16,
                               base_quant="int8" if int8 else "none", base_quant_min_dim=32)
    proc = Sam3Processor(cfg, chip_smoke.LORA, device="cpu")
    proc.set_image(IMAGE)
    chip_smoke.check_launches("set_image", chip_smoke.counts(), chip_smoke.set_image_launches(cfg))
    for boxes in (None, chip_smoke.PROC_BOX):
        chip_smoke.reset_counts()
        proc.set_text_prompt("crack", boxes=boxes)
        chip_smoke.check_launches("prompt", chip_smoke.counts(), chip_smoke.prompt_launches(cfg))
    full = chip_smoke.model_config(int8)
    assert chip_smoke.set_image_launches(full)["window_attention_rope_packed"] == 28
    assert chip_smoke.set_image_launches(full)["long_attention_rope_packed"] == 4
    assert chip_smoke.prompt_launches(full)["long_attention_packed"] == 6


if __name__ == "__main__":
    print(write_reference())
    print(write_mask_prompt_reference())
