"""Weight bridge of the PyTorch port: a JAX init of the tiny config (scanned
ViT layout, adapters included) loads strictly into the port, and adapter
.npz files round-trip between the packages."""

import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models.builder import dummy_batch
from sam3_lora_tpu.models.lora import save_lora_weights as jax_save_lora
from sam3_lora_tpu_torch.models import build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.lora import load_lora_weights, lora_state, save_lora_weights
from sam3_lora_tpu_torch.models.vit import qkv_out_perm
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params, params_from_jax

from torch_port_helpers import random_jax_params

LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))


@pytest.fixture(scope="module")
def jax_init():
    cfg = tiny_model_config()
    assert cfg.vit_scan_blocks  # the JAX default layout
    model = build_jax(cfg, lora=LORA)
    params, flat = random_jax_params(model, dummy_batch(cfg), train=False)
    return cfg, params, flat


def test_strict_load_of_scanned_jax_init(jax_init):
    cfg, _, flat = jax_init
    assert any(".scan_blocks_" in k for k in flat)
    port = build_sam3_image_model(cfg, lora=LORA)
    n = load_jax_params(port, flat, strict=True)
    named = dict(port.named_parameters())
    assert n == len(named)  # no missing and (load_jax_params raises on) no extra keys
    assert sum(k.endswith("lora_b") for k in named) > 0

    # scanned block 1 of group 0 is flat block 1; a Linear kernel transposes
    key = "backbone.vision_backbone.trunk.scan_blocks_0.block.mlp.fc1.kernel"
    np.testing.assert_array_equal(
        named["backbone.vision_backbone.trunk.blocks.0.mlp.fc1.weight"].numpy(), flat[key][0].T
    )
    # with globals (1, 3) and depth 4, group 1 holds block 2
    np.testing.assert_array_equal(
        named["backbone.vision_backbone.trunk.blocks.2.mlp.fc2.weight"].numpy(),
        flat["backbone.vision_backbone.trunk.scan_blocks_1.block.mlp.fc2.kernel"][0].T,
    )
    # the rotate-half permutation is folded into the qkv rows, bias and lora_b
    perm = qkv_out_perm(cfg.vit_dim, cfg.vit_heads)
    pre = "backbone.vision_backbone.trunk"
    np.testing.assert_array_equal(
        named[f"{pre}.blocks.1.attn.qkv.weight"].numpy(),
        flat[f"{pre}.blocks.1.attn.qkv.kernel"].T[perm],
    )
    np.testing.assert_array_equal(
        named[f"{pre}.blocks.1.attn.qkv.lora_b"].numpy(),
        flat[f"{pre}.blocks.1.attn.qkv.lora_b"].T[perm],
    )
    # conv kernels (kh, kw, in, out) -> (out, in, kh, kw)
    np.testing.assert_array_equal(
        named[f"{pre}.patch_embed.proj.weight"].numpy(),
        flat[f"{pre}.patch_embed.proj.kernel"].transpose(3, 2, 0, 1),
    )


def test_strict_load_rejects_unknown_and_missing_keys(jax_init):
    cfg, _, flat = jax_init
    port = build_sam3_image_model(cfg, lora=LORA)
    with pytest.raises(KeyError, match="not in model"):
        load_jax_params(port, {**flat, "transformer.decoder.bogus.kernel": np.zeros((2, 2))})
    partial = {k: v for k, v in flat.items() if "segmentation_head" not in k}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(port, partial)


def test_adapter_npz_round_trip(jax_init, tmp_path):
    cfg, params, flat = jax_init
    # JAX-written adapter file (scanned names) -> port
    jax_path = str(tmp_path / "jax_lora.npz")
    n_saved = jax_save_lora(params, jax_path)
    port = build_sam3_image_model(cfg, lora=LORA)
    init_model(port, torch.Generator().manual_seed(0))
    n_adapter_tensors = sum(k.endswith(("lora_a", "lora_b")) for k in params_from_jax(flat))
    assert load_lora_weights(port, jax_path) == n_adapter_tensors
    ref = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(ref, flat)
    for (k, a), (_, b) in zip(port.named_parameters(), ref.named_parameters()):
        if k.endswith(("lora_a", "lora_b")):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    # port -> file in the JAX layout (flat block names) -> fresh port model
    port_path = str(tmp_path / "port_lora.npz")
    assert save_lora_weights(port, port_path) == n_saved
    state = lora_state(port)
    pre = "backbone.vision_backbone.trunk"
    np.testing.assert_array_equal(
        state[f"{pre}.blocks.0.attn.qkv.lora_b"],
        flat[f"{pre}.scan_blocks_0.block.attn.qkv.lora_b"][0],
    )
    fresh = build_sam3_image_model(cfg, lora=LORA)
    init_model(fresh, torch.Generator().manual_seed(1))
    load_lora_weights(fresh, port_path)
    for (k, a), (_, b) in zip(fresh.named_parameters(), port.named_parameters()):
        if k.endswith(("lora_a", "lora_b")):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_adapter_load_rejects_base_tensors(jax_init, tmp_path):
    cfg, _, flat = jax_init
    path = str(tmp_path / "bad.npz")
    key = "backbone.language_backbone.resizer.kernel"
    np.savez(path, **{key: flat[key]})
    port = build_sam3_image_model(cfg, lora=LORA)
    with pytest.raises(KeyError, match="not adapter"):
        load_lora_weights(port, path)
