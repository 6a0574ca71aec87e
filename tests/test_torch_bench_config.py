"""``bench.py``'s training configuration in the PyTorch port, on the CPU:

* ``bench_model_config()``/``bench_lora_config()`` equal ``bench.py``'s,
  under its ``BENCH_*`` environment variables;
* the adapters they build have the JAX model's names and shapes (no
  ``out_proj`` adapter: ``should_apply`` skips it in both packages);
* bf16 storage of the frozen base: every parameter has the JAX dtype; a JAX
  bf16 init, in memory or through an ``.npz``, loads bit for bit; the int8
  tier quantizes the bf16 weights as ``prequantize_base`` does, bit for bit;
* ``Trainer`` fits with that storage at the bench settings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from sam3_lora_tpu.config import tiny_model_config as jtiny
from sam3_lora_tpu.models import build_sam3_image_model as jbuild
from sam3_lora_tpu.models.builder import dummy_batch as jdummy
from sam3_lora_tpu.ops.quant import prequantize_base
from sam3_lora_tpu_torch.config import (
    TrainConfig, bench_lora_config, bench_model_config, tiny_model_config,
)
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import lora_state
from sam3_lora_tpu_torch.ops import quant
from sam3_lora_tpu_torch.train.data import DataLoader
from sam3_lora_tpu_torch.train.trainer import Trainer
from sam3_lora_tpu_torch.utils.checkpoint import load_base_checkpoint, load_jax_params

from torch_port_helpers import fill_params

ENVS = [
    {},
    {"BENCH_QUANT": "none", "BENCH_REMAT": "full", "BENCH_ENC_REMAT": "1",
     "BENCH_DEC_REMAT": "1"},
    {"BENCH_ENC_REMAT": "0", "BENCH_PARAM_DTYPE": "float32", "BENCH_SCAN": "1",
     "BENCH_QUANT": "int8_bwd", "BENCH_REMAT": "block_mid"},
]
# bench.py's settings at a tiny width (int8 gate 16: every layer that wide)
TINY_BENCH = dict(param_dtype="bfloat16", base_quant="int8", base_quant_min_dim=16,
                  vit_remat_policy="wo_block_mid", enc_remat=False, enc_remat_ffn=True,
                  dec_remat=False, vit_scan_blocks=False)


@pytest.mark.parametrize("env", ENVS)
def test_bench_configs_equal_bench_py(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(bench_model_config()) == dataclasses.asdict(bench.bench_model_config())
    assert dataclasses.asdict(bench_lora_config()) == dataclasses.asdict(bench.bench_lora_config())


def test_bad_enc_remat_setting_is_refused(monkeypatch):
    monkeypatch.setenv("BENCH_ENC_REMAT", "yes")
    with pytest.raises(ValueError, match="BENCH_ENC_REMAT"):
        bench_model_config()


@pytest.fixture(scope="module")
def jax_shapes():
    """The JAX tiny model at the bench settings with the bench adapters:
    its parameters' names, shapes and dtypes (no init compiled)."""
    cfg = jtiny(**TINY_BENCH)
    jm = jbuild(cfg, lora=bench.bench_lora_config())
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jdummy(cfg, 1),
                                            train=False))["params"]
    from flax import traverse_util

    return {".".join(k): v for k, v in traverse_util.flatten_dict(shapes).items()}


def _port_model():
    return build_sam3_image_model(tiny_model_config(**TINY_BENCH), lora=bench_lora_config(),
                                  device="cpu")


def test_bench_adapters_equal_jax(jax_shapes):
    jax_adapters = {k: v.shape for k, v in jax_shapes.items() if k.endswith(("lora_a", "lora_b"))}
    port = {k: v.shape for k, v in lora_state(_port_model()).items()}
    assert port == jax_adapters and port
    assert not any("out_proj" in k or "language_backbone" in k for k in port)


def _port_name(jax_name: str) -> str:
    base, leaf = jax_name.rsplit(".", 1)
    return f"{base}.{ {'kernel': 'weight', 'kernel_scale': 'weight_scale'}.get(leaf, leaf)}"


def _bf16_init(jax_shapes):
    """fill_params values in each JAX leaf's dtype (ml_dtypes bfloat16 for
    the bf16 leaves)."""
    specs = [(tuple(k.split(".")), tuple(v.shape)) for k, v in sorted(jax_shapes.items())]
    flat = fill_params(specs)
    return {k: v.astype(ml_dtypes.bfloat16) if jax_shapes[k].dtype == jnp.bfloat16 else v
            for k, v in flat.items()}


def test_bf16_storage_loads_and_quantizes_like_jax(jax_shapes, tmp_path):
    flat = _bf16_init(jax_shapes)
    assert any(v.dtype == ml_dtypes.bfloat16 for v in flat.values())
    path = str(tmp_path / "base.npz")
    np.savez(path, **flat)  # numpy writes the bf16 leaves as 2-byte voids
    quantized = prequantize_base({tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()},
                                 min_dim=16)
    for source in ("memory", "npz"):
        model = _port_model()
        if source == "memory":
            load_jax_params(model, flat)
        else:
            load_base_checkpoint(model, path, strict=False)
        dtypes = {_port_name(k): str(v.dtype) for k, v in jax_shapes.items()}
        assert {n: str(p.dtype)[len("torch."):] for n, p in model.named_parameters()} == dtypes
        lin = model.backbone.vision_backbone.trunk.blocks[0].mlp.fc1
        assert lin.weight.dtype == torch.bfloat16
        key = "backbone.vision_backbone.trunk.blocks.0.mlp.fc1.kernel"
        np.testing.assert_array_equal(lin.weight.float().numpy(), flat[key].astype(np.float32).T)
        assert quant.prequantize_model(model, 16) > 0
        for name, m in model.named_modules():
            if isinstance(m, LoRALinear) and m.weight.dtype == torch.int8:
                q = np.asarray(quantized[tuple(f"{name}.kernel".split("."))])
                s = np.asarray(quantized[tuple(f"{name}.kernel_scale".split("."))])
                if m.out_perm is not None:  # the bridge folded the qkv column order
                    q, s = q[:, m.out_perm.numpy()], s[:, m.out_perm.numpy()]
                np.testing.assert_array_equal(m.weight.numpy(), q.T, err_msg=name)
                np.testing.assert_array_equal(m.weight_scale.detach().numpy(), s[0], err_msg=name)


def test_trainer_fits_with_bf16_storage_at_the_bench_settings(tmp_path):
    cfg = tiny_model_config(**TINY_BENCH)
    tcfg = TrainConfig(batch_size=2, num_epochs=1, warmup_steps=0, logging_steps=1,
                       num_workers=1, seed=0, output_dir=str(tmp_path), device_prefetch=0)
    trainer = Trainer(cfg, bench_lora_config(), tcfg, device="cpu")
    loader = DataLoader(chip_smoke.SyntheticSamples(cfg, 4, 0), 2, shuffle=False, num_workers=1)
    trainer.setup(steps_per_epoch=len(loader))
    before = {n: p.detach().clone() for n, p in zip(trainer.trainable_names, trainer.trainable)}
    result = trainer.fit(loader)
    assert result["steps"] == 2 and np.isfinite(result["history"]["train_loss"]).all()
    dtypes = {p.dtype for n, p in trainer.model.named_parameters() if not n.endswith(("lora_a", "lora_b"))}
    assert torch.int8 in dtypes and torch.bfloat16 in dtypes
    for n, p in zip(trainer.trainable_names, trainer.trainable):
        assert p.dtype == torch.float32, n
    assert any(not torch.equal(before[n], p) for n, p in zip(trainer.trainable_names, trainer.trainable))
