"""The whole eval forward of the PyTorch port against the JAX package.

Same numpy-seeded weights (a JAX init in the scanned layout, through the
weight bridge) and the same batch; every output key of ``Sam3Image`` and of
``SAM3LoRAInference._forward`` compared in fp32. Tolerance 2e-4 absolute and
relative: ~20 stacked fp32 layers whose sums run in another order (measured
max error ~1e-5). ``predict`` is held against the JAX engine's ``predict``
on a uint8 image (boxes, scores, masks). A second config widens the ViT and the fusion encoder so
that the port's K1/K2/K3 entry points sit on the path (and the JAX package's
Pallas kernels, run in interpret mode, on its own). The CLI is driven on the
tiny config.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models.geometry import GeoPrompt as JGeoPrompt
from sam3_lora_tpu.models.sam3_image import Batch as JBatch
from sam3_lora_tpu.ops import long_attention as la
from sam3_lora_tpu.ops import window_attention as wa
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, build_sam3_image_model
from sam3_lora_tpu_torch.models import layers as port_layers
from sam3_lora_tpu_torch.models import vit as port_vit
from sam3_lora_tpu_torch.ops import window_attention as port_wa
from sam3_lora_tpu_torch.models.lora import save_lora_weights
from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import assert_close, jax_apply, random_jax_params

TOL = 2e-4
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
WIDE = dict(vit_dim=128, vit_heads=2, d_model=128, enc_heads=4, flash_attention_min_seq=16)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.standard_normal((2, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    ids = get_default_tokenizer()(["crack", "a small dog", "tree"],
                                  context_length=cfg.text_context_length)
    img_ids = np.array([0, 1, 0], np.int32)
    boxes = np.array([[[0.5, 0.5, 0.4, 0.3], [0, 0, 0, 0]], [[0.3, 0.6, 0.5, 0.7], [0.7, 0.2, 0.2, 0.1]],
                      [[0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    mask = np.array([[False, True], [False, False], [True, True]])
    labels = np.array([[1, 1], [1, 0], [1, 1]], np.int32)
    jb = JBatch(images=jnp.asarray(images), token_ids=jnp.asarray(ids), img_ids=jnp.asarray(img_ids),
                geo=JGeoPrompt(jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(labels)))
    T = torch.from_numpy
    tb = Batch(images=T(images), token_ids=T(ids).long(), img_ids=T(img_ids).long(),
               geo=GeoPrompt(T(boxes), T(mask), T(labels).long()))
    return jb, tb


def _run_forward(cfg):
    jm = build_jax(cfg, lora=LORA)
    jb, tb = _batch(cfg)
    params, flat = random_jax_params(jm, jb, train=False)
    ref = jax_apply(jm, params, jb, train=False)
    port = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(port, flat)
    with torch.no_grad():
        out = port(tb)
    return out, ref, params, flat, jm


def _assert_outputs_match(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert out[k] is None, k
        elif k == "prompt_mask":
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        else:
            assert tuple(out[k].shape) == tuple(ref[k].shape), k
            assert_close(out[k], ref[k], rtol=TOL, atol=TOL, name=k)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_model_config()
    assert cfg.vit_scan_blocks
    return (cfg, *_run_forward(cfg))


def test_eval_forward_matches_jax_every_key(tiny):
    _, out, ref, _, _, _ = tiny
    _assert_outputs_match(out, ref)


def test_inference_forward_matches_jax(tiny):
    cfg, _, _, params, flat, jm = tiny
    rng = np.random.RandomState(3)
    img = rng.standard_normal((1, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    ids = get_default_tokenizer()(["crack", "wall"], context_length=cfg.text_context_length)
    jb = JBatch(images=jnp.asarray(img), token_ids=jnp.asarray(ids),
                img_ids=jnp.zeros((2,), jnp.int32), geo=JGeoPrompt.empty(2, cfg.max_prompt_boxes))
    ref = jax_apply(jm, params, jb, train=False)
    engine = SAM3LoRAInference(cfg, LORA, device="cpu")
    load_jax_params(engine.model, flat)
    scores, presence, boxes, masks = engine._forward(torch.from_numpy(img),
                                                     torch.from_numpy(ids).long())
    sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))  # noqa: E731
    assert_close(scores, sig(ref["pred_logits"][-1][..., 0]), rtol=TOL, atol=TOL)
    assert_close(presence, sig(ref["presence_logit_dec"][-1][..., 0]), rtol=TOL, atol=TOL)
    assert_close(boxes, ref["pred_boxes"][-1], rtol=TOL, atol=TOL)
    assert_close(masks, sig(ref["pred_masks"]), rtol=TOL, atol=TOL)


def test_predict_matches_jax(tiny, monkeypatch):
    """``predict`` end to end, both engines on the same weights and uint8
    image. The two resizes give identical input (test_torch_inference.py),
    so scores and boxes hold to TOL (boxes scaled by the image side). The
    masks are resized as PIL resizes them, and may differ only where a
    low-resolution probability lies at the 0.5 threshold: at most 1%."""
    from sam3_lora_tpu import inference as jax_inference

    cfg, _, _, params, flat, _ = tiny
    # the JAX engine takes the fixture's weights in place of its own init
    monkeypatch.setattr(jax_inference, "init_model", lambda model, key: params)
    ref_engine = jax_inference.SAM3LoRAInference(cfg, LORA)
    engine = SAM3LoRAInference(cfg, LORA, device="cpu")
    load_jax_params(engine.model, flat)
    image = np.random.RandomState(5).randint(0, 256, (40, 60, 3)).astype(np.uint8)
    np.testing.assert_array_equal(engine.preprocess(image)[0], ref_engine.preprocess(image)[0])
    prompts = ["crack", "a small dog"]
    for threshold, use_presence in ((0.0, False), (0.5, False), (0.3, True)):
        out = engine.predict(image, prompts, threshold=threshold, use_presence=use_presence)
        ref = ref_engine.predict(image, prompts, threshold=threshold, use_presence=use_presence)
        assert sorted(out) == sorted(ref) == [0, 1]
        for qi in ref:
            o, r = out[qi], ref[qi]
            assert o["prompt"] == r["prompt"] and o["num_detections"] == r["num_detections"]
            if r["num_detections"] == 0:
                assert o["boxes"] is o["scores"] is o["masks"] is None
                continue
            assert_close(o["scores"], r["scores"], rtol=TOL, atol=TOL)
            assert_close(o["boxes"], r["boxes"], rtol=TOL, atol=TOL * 60)
            assert o["masks"].shape == r["masks"].shape == (r["num_detections"], 40, 60)
            assert o["masks"].dtype == r["masks"].dtype == bool
            assert (o["masks"] != r["masks"]).mean() <= 0.01
    assert any(r["num_detections"] for r in ref.values())


def test_wide_config_runs_the_kernel_entry_points(monkeypatch):
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(la, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(port_wa, "_FORCE_INTERPRET", True)  # the port's card routes on the CPU
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a):
            calls[key] += 1
            return fn(*a)

        monkeypatch.setattr(mod, name, wrapped)

    spy(port_wa, "window_attention_rope_packed_qkv", "K1")
    spy(port_vit, "long_attention_rope_packed_qkv", "K2")
    spy(port_layers, "long_attention_packed", "K3")
    cfg = tiny_model_config(**WIDE)
    out, ref, *_ = _run_forward(cfg)
    _assert_outputs_match(out, ref)
    n_global = len(cfg.vit_global_blocks)
    assert calls == {"K1": cfg.vit_depth - n_global, "K2": n_global, "K3": cfg.enc_layers}


def test_cli_infer_tiny(tmp_path, capsys):
    pytest.importorskip("yaml")
    pytest.importorskip("matplotlib")
    from PIL import Image

    from sam3_lora_tpu_torch.cli import infer

    cfg = tiny_model_config()
    lora = str(tmp_path / "lora.npz")
    model = build_sam3_image_model(cfg, lora=LORA)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    save_lora_weights(model, lora)
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(
        "model: {tiny: true}\n"
        "lora: {rank: 4, alpha: 8.0, target_modules: [qkv, fc1, fc2, linear1, linear2]}\n"
        f"output: {{output_dir: {tmp_path}}}\n"
    )
    img = tmp_path / "x.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (40, 60, 3)).astype(np.uint8)).save(img)
    out = tmp_path / "out.png"
    infer.main(["--config", str(yaml_path), "--weights", lora, "--image", str(img),
                "--prompt", "crack", "dog", "--output", str(out), "--threshold", "0.0",
                "--device", "cpu"])
    text = capsys.readouterr().out
    assert "'crack': 12 detections" in text and "'dog': 12 detections" in text
    assert out.exists()
