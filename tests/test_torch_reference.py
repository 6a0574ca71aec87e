"""The port's whole eval forward and training step against the JAX package's,
from stored references (``tests/data/torch_ref_<case>.npz``, written by
``tests/make_torch_reference.py``), so the comparison runs in seconds with no
JAX model to trace.

Six cases on the tiny config with fp32 compute, LoRA rank 4: the eval
forward and the training step, each with the fp32 base, with the int8 tier
(``base_quant="int8"``, ``base_quant_min_dim=16``; the port quantizes its
base with ``prequantize_model``, the reference with the JAX package's
``prequantize_base``) and at ``bench.py``'s settings (``_bench``: the int8
tier over a bf16-stored base, ``wo_block_mid``, ``enc_remat_ffn``, the bench
adapter targets; ``make_torch_reference.py`` lists them). The weights are
rebuilt from the stored [name, shape] list with the same numpy seed and go
through the weight bridge, which rounds them to bf16 where the base is
stored so, as JAX's ``astype``; the batch is stored.

Tolerances. fp32 base: outputs 2e-4 absolute and relative (as
``test_torch_slice.py``), losses 1e-4 relative, adapter gradients 2e-3 of
each gradient's largest entry (as ``test_torch_train_step.py``). int8 base:
each of the 63 quantized layers rounds its input to int8 steps, so an fp32
difference of one part in 1e7 (sums taken in another order) could move an
activation that sits at a rounding boundary by one step, about 1/127 of its
row's largest entry. On these inputs no step moves (measured: outputs within
4.4e-6 (int8) and 4.8e-6 (bench), losses 4e-7, gradients 2.8e-6 of their
largest entry, as close as the fp32 base); the bounds, 2e-3 of the outputs,
1e-3 of the losses and 2e-2 of each gradient's largest entry, leave room for
such a step. The bench references' outputs are written op by op: under
``jax.jit`` XLA quantizes by multiplying with 1/127 where the JAX code and
the port divide, and at the bench settings that moves steps (outputs off by
8e-2). Their losses and gradients come from the jitted ``value_and_grad``, as
in the other cases (measured: losses 2.3e-7, gradients 2.0e-6; op by op,
JAX's own gradients drifted from the jitted ones by 1.1e-2 of the largest).
The matching is held equal in every case.

``test_reference_files_are_current`` (slow) regenerates the files with JAX
and holds them equal to the committed ones.
"""

import functools
import json
import os

import numpy as np
import pytest
import scipy.optimize  # noqa: F401  the exact matcher's solver
import torch
import torch._dynamo  # noqa: F401  torch.utils.checkpoint imports it at its first call

from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, Targets, build_sam3_image_model
from sam3_lora_tpu_torch.models.lora import lora_state, trainable_parameters
from sam3_lora_tpu_torch.ops.quant import prequantize_model
from sam3_lora_tpu_torch.train.losses import compute_losses
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params, stack_scanned

from torch_port_helpers import assert_close, fill_params

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
LORA_BENCH = LoRAConfig(rank=4, alpha=8.0, target_modules=(
    "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2", "linear1", "linear2"),
    apply_to_geometry_encoder=True, apply_to_mask_decoder=True)
QUANT = dict(base_quant="int8", base_quant_min_dim=16)
# as in the full config, the int8 gate takes the ViT and the text encoder
# (32 wide here) and not the 16-wide detection heads
BENCH = dict(base_quant="int8", base_quant_min_dim=32, d_model=16, param_dtype="bfloat16",
             vit_remat_policy="wo_block_mid", enc_remat=False, enc_remat_ffn=True,
             dec_remat=False, vit_scan_blocks=False)
OVERRIDES = {"": {}, "int8": QUANT, "bench": BENCH}
CASES = ("eval", "eval_int8", "train", "train_int8", "eval_bench", "train_bench")
TRAIN = ("train", "train_int8", "train_bench")


def _variant(name: str) -> str:
    return name.split("_", 1)[1] if "_" in name else ""
EXACT = ("prompt_mask", "indices", "o2m_indices", "o2m_valid")
TOLS = {  # (outputs, losses relative, gradients relative to their max)
    "": (2e-4, 1e-4, 2e-3),
    "int8": (2e-3, 1e-3, 2e-2),
    "bench": (2e-3, 1e-3, 2e-2),
}


def _load(name: str) -> dict:
    with np.load(os.path.join(DATA, f"torch_ref_{name}.npz")) as data:
        return {k: data[k] for k in data.files}


def _batch(ref: dict) -> Batch:
    T = {k[3:]: torch.from_numpy(v) for k, v in ref.items() if k.startswith("in/")}
    targets = None
    if "boxes" in T:
        targets = Targets(T["boxes"], T["valid"], T["masks"], T["mask_valid"], T["is_exhaustive"])
    return Batch(images=T["images"], token_ids=T["token_ids"].long(), img_ids=T["img_ids"].long(),
                 geo=GeoPrompt(T["geo_boxes"], T["geo_mask"], T["geo_labels"].long()),
                 targets=targets)


@functools.lru_cache(maxsize=None)
def _run(name: str):
    """The port on one case: (reference arrays, outputs, losses, gradients)."""
    ref = _load(name)
    cfg = tiny_model_config(**OVERRIDES[_variant(name)])
    specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(ref["params"]))]
    flat = fill_params(specs)
    model = build_sam3_image_model(cfg, lora=LORA_BENCH if _variant(name) == "bench" else LORA)
    load_jax_params(model, flat)
    if cfg.base_quant != "none":
        assert prequantize_model(model, cfg.base_quant_min_dim) > 0
    batch = _batch(ref)
    if name not in TRAIN:
        with torch.no_grad():
            return ref, model(batch), None, None
    model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0  # as the reference's
    params = trainable_parameters(model)
    model.train()
    out = model(batch)
    losses = compute_losses(out, batch.targets)
    losses["core_loss"].backward()
    with torch.no_grad():  # the gradients under the JAX names and layout
        saved = [p.detach().clone() for _, p in params]
        for _, p in params:
            p.copy_(p.grad)
        grads = lora_state(model)
        if cfg.vit_scan_blocks:
            grads = stack_scanned(grads, cfg)
        for (_, p), s in zip(params, saved):
            p.copy_(s)
    return ref, out, losses, grads


@pytest.mark.parametrize("name", CASES)
def test_outputs_match_jax_every_key(name):
    ref, out, _, _ = _run(name)
    tol = TOLS[_variant(name)][0]
    none_keys = set(json.loads(str(ref["none_keys"])))
    keys = {k[4:] for k in ref if k.startswith("out/")}
    assert set(out) == keys | none_keys
    for k in none_keys:
        assert out[k] is None, k
    for k in keys:
        r = ref[f"out/{k}"]
        if k in EXACT:
            np.testing.assert_array_equal(out[k].numpy(), r, err_msg=k)
        else:
            assert tuple(out[k].shape) == r.shape, k
            assert_close(out[k], r, rtol=tol, atol=tol, name=k)
    if name in TRAIN:
        assert (ref["out/indices"] >= 0).any()


@pytest.mark.parametrize("name", TRAIN)
def test_losses_match_jax(name):
    ref, _, losses, _ = _run(name)
    tol = TOLS[_variant(name)][1]
    terms = {k[5:] for k in ref if k.startswith("loss/")}
    assert sorted(losses) == sorted(terms)
    for k in terms:
        assert_close(losses[k], ref[f"loss/{k}"], rtol=tol, atol=1e-5, name=k)


@pytest.mark.parametrize("name", TRAIN)
def test_adapter_gradients_match_jax(name):
    ref, _, _, grads = _run(name)
    tol = TOLS[_variant(name)][2]
    names = {k[5:] for k in ref if k.startswith("grad/")}
    assert sorted(grads) == sorted(names) and names
    for k in names:
        r = ref[f"grad/{k}"]
        scale = float(np.abs(r).max())
        assert scale > 0, k
        assert_close(grads[k], r, rtol=0, atol=tol * scale, name=k)


@pytest.mark.slow
def test_reference_files_are_current(tmp_path):
    """Regenerate every reference with JAX: equal to the committed files
    (fp32 on the CPU, so to rounding: 1e-6 relative and absolute)."""
    import make_torch_reference

    for path in make_torch_reference.write(str(tmp_path)):
        name = os.path.basename(path)[len("torch_ref_"):-len(".npz")]
        with np.load(path) as data:
            new = {k: data[k] for k in data.files}
        old = _load(name)
        assert sorted(new) == sorted(old), name
        for k in old:
            if old[k].dtype.kind in "US":
                assert str(new[k]) == str(old[k]), (name, k)
            else:
                np.testing.assert_allclose(new[k], old[k], rtol=1e-6, atol=1e-6, err_msg=f"{name} {k}")
