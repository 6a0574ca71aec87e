"""The port's ``save_base_checkpoint`` against the JAX package's, on the
tiny trees stored with ``tests/data/torch_ref_train.npz`` (fp32 storage, the
scanned ViT) and ``torch_ref_eval_bench.npz`` (bf16 storage, the int8 tier,
unscanned), filled with the same seeded values on both sides:

* the same keys as JAX's ``save_base_checkpoint`` of the same params (no
  adapter, no ``kernel_scale`` / ``weight_scale``);
* fp32 leaves byte for byte: each ``.npy`` member of the two archives (its
  header and data) is equal;
* bf16 leaves: JAX writes them as numpy's 2-byte void, which its own loader
  cannot cast (pinned below); the port writes the exact fp32 widening, so
  each of its values is JAX's bf16 bits shifted up 16, with zero low bits;
* JAX's ``load_base_checkpoint`` takes the port's file strictly, every
  leaf bit for bit the tree's;
* the port's loader takes it strictly into a fresh model, every parameter
  bit for bit; the int8 tier round-trips by saving the float base, and a
  prequantized model refuses to save."""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sam3_lora_tpu.utils.checkpoint import load_base_checkpoint as jax_load_base
from sam3_lora_tpu.utils.checkpoint import save_base_checkpoint as jax_save_base
from sam3_lora_tpu_torch.config import tiny_model_config
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.ops.quant import prequantize_model
from sam3_lora_tpu_torch.utils.checkpoint import (
    base_params_to_jax, load_base_checkpoint, load_jax_params, save_base_checkpoint)

from test_torch_reference import BENCH, LORA, LORA_BENCH, _load
from torch_port_helpers import fill_params

CASES = {"fp32": ("train", {}, LORA), "bf16": ("eval_bench", BENCH, LORA_BENCH)}


def _setup(case):
    ref_name, overrides, lora = CASES[case]
    specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(_load(ref_name)["params"]))]
    flat = fill_params(specs)
    cfg = tiny_model_config(**overrides)
    model = build_sam3_image_model(cfg, lora=lora)
    load_jax_params(model, flat)
    # the JAX tree in the port's storage dtypes (bf16 where the base is stored so)
    dtypes = {k.replace(".kernel", ".weight"): p.dtype for k, p in model.named_parameters()}
    tree = traverse_util.unflatten_dict({  # numpy leaves (ml_dtypes bf16): no dispatch a leaf
        path: flat[".".join(path)].astype(
            jnp.bfloat16 if dtypes.get(".".join(path).replace(".kernel", ".weight"))
            == torch.bfloat16 else np.float32)
        for path, _ in specs})
    return cfg, lora, model, tree


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n[:-len(".npy")]: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("case", list(CASES))
def test_file_equals_jax_and_jax_loads_it_strictly(case, tmp_path):
    cfg, _, model, tree = _setup(case)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    n = save_base_checkpoint(model, port_path)
    assert n == jax_save_base(tree, jax_path)
    port, ref = _members(port_path), _members(jax_path)
    assert sorted(port) == sorted(ref)
    assert not any(k.endswith(("lora_a", "lora_b", "kernel_scale")) for k in port)
    n_bf16 = 0
    with np.load(port_path) as p, np.load(jax_path) as j:
        for k in ref:
            if j[k].dtype == np.dtype("V2"):  # JAX's bf16 leaf
                n_bf16 += 1
                bits = p[k].view(np.uint32)
                assert p[k].dtype == np.float32 and not (bits & 0xFFFF).any(), k
                np.testing.assert_array_equal((bits >> 16).astype(np.uint16),
                                              j[k].view(np.uint16), err_msg=k)
            else:
                assert port[k] == ref[k], k  # the .npy header and data
    assert (n_bf16 > 0) == (case == "bf16")
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    loaded, count = jax_load_base(zeros, port_path, strict=True)
    assert count == n
    flat_ref, flat_got = traverse_util.flatten_dict(tree), traverse_util.flatten_dict(loaded)
    for k, v in flat_ref.items():
        if k[-1] not in ("lora_a", "lora_b", "kernel_scale"):
            assert flat_got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(np.asarray(flat_got[k], np.float32),
                                          np.asarray(v, np.float32), err_msg=".".join(k))
    if case == "bf16":  # JAX's own bf16 file is not loadable by JAX
        with pytest.raises(ValueError):
            jax_load_base(zeros, jax_path, strict=True)


@pytest.mark.parametrize("case", list(CASES))
def test_port_round_trip_bit_for_bit(case, tmp_path):
    cfg, lora, model, _ = _setup(case)
    path = str(tmp_path / "base.npz")
    save_base_checkpoint(model, path)
    fresh = build_sam3_image_model(cfg, lora=lora)
    assert load_base_checkpoint(fresh, path, strict=True) > 0
    want, got = dict(model.named_parameters()), dict(fresh.named_parameters())
    for k, v in want.items():
        if not k.endswith(("lora_a", "lora_b", "weight_scale")):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if cfg.base_quant != "none":  # the int8 tier: quantized after loading, as directly
        assert prequantize_model(model, cfg.base_quant_min_dim) > 0
        assert prequantize_model(fresh, cfg.base_quant_min_dim) > 0
        for k, v in dict(model.named_parameters()).items():
            if not k.endswith(("lora_a", "lora_b")):
                assert torch.equal(dict(fresh.named_parameters())[k], v), k
        with pytest.raises(ValueError, match="prequantize"):
            base_params_to_jax(model)
