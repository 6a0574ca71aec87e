"""``python -m sam3_lora_tpu_torch.cli.train`` end to end on the CPU: the tiny
config over a synthetic COCO dataset with a validation split. Checked:
finite losses in ``train_stats.json`` and ``val_stats.json``, the adapter
and state files, auto-resume from ``train_state.npz``, and that
``last_lora.npz`` loads into the JAX model, whose eval forward then equals
the port's on the same adapters (fp32, 2e-4 as in ``test_torch_slice.py``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models.geometry import GeoPrompt as JGeoPrompt
from sam3_lora_tpu.models.lora import load_lora_weights as jax_load_lora_weights
from sam3_lora_tpu.models.sam3_image import Batch as JBatch
from sam3_lora_tpu_torch.cli import train as cli_train
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, build_sam3_image_model
from sam3_lora_tpu_torch.models.lora import load_lora_weights
from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer
from sam3_lora_tpu_torch.train.data import make_synthetic_coco
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import assert_close, jax_apply, random_jax_params

TARGETS = ("qkv", "fc1", "fc2", "linear1", "linear2")
STEPS_PER_EPOCH = 2  # 4 images, batch 2


def _stats(out_dir):
    with open(os.path.join(out_dir, "train_stats.json")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    data, out = str(base / "data"), str(base / "out")
    make_synthetic_coco(data, "train", num_images=4, img_size=64, seed=1)
    make_synthetic_coco(data, "valid", num_images=2, img_size=64, seed=2)
    yaml_path = str(base / "config.yaml")
    with open(yaml_path, "w") as f:
        f.write(
            "model:\n  tiny: true\n"
            "lora:\n  rank: 4\n  alpha: 8\n  target_modules: [" + ", ".join(TARGETS) + "]\n"
            "training:\n  data_dir: " + data + "\n  batch_size: 2\n  num_epochs: 2\n"
            "  warmup_steps: 1\n  logging_steps: 1\n  num_workers: 1\n  learning_rate: 1e-3\n"
            "output:\n  output_dir: " + out + "\n"
        )
    result = cli_train.main(["--config", yaml_path, "--device", "cpu"])
    return dict(yaml=yaml_path, out=out, result=result)


def test_cli_train_writes_stats_and_adapter_files(run):
    out = run["out"]
    assert run["result"]["steps"] == 2 * STEPS_PER_EPOCH
    stats = _stats(out)
    assert [s["step"] for s in stats] == list(range(1, 2 * STEPS_PER_EPOCH + 1))
    assert all(np.isfinite(s["loss"]) for s in stats)
    assert stats[0]["lr"] > 0 and "loss/loss_mask" in stats[0]
    for name in ("last_lora.npz", "best_lora.npz", "train_state.npz", "result.json",
                 "train.log"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "val_stats.json")) as f:
        val = [json.loads(line) for line in f]
    assert [v["epoch"] for v in val] == [0, 1] and all(np.isfinite(v["val_loss"]) for v in val)
    assert run["result"]["best_val_loss"] == min(v["val_loss"] for v in val)


def test_last_lora_round_trips_into_jax(run):
    """The trained adapters, loaded into the JAX model and into the port on
    the same (JAX-initialised) base weights, give the same eval forward."""
    cfg = tiny_model_config()
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS)
    jm = build_jax(cfg, lora=lora)
    rng = np.random.RandomState(2)
    images = rng.standard_normal((1, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    ids = np.asarray(get_default_tokenizer()(["crack", "wall"],
                                             context_length=cfg.text_context_length))
    jb = JBatch(jnp.asarray(images), jnp.asarray(ids), jnp.zeros((2,), jnp.int32),
                JGeoPrompt.empty(2, cfg.max_prompt_boxes))
    params, flat = random_jax_params(jm, jb, train=False, seed=7)
    path = os.path.join(run["out"], "last_lora.npz")
    params, n = jax_load_lora_weights(params, path)
    assert n > 0
    with np.load(path) as data:  # training moved the zero-initialised lora_b
        assert any(np.abs(data[k]).max() > 0 for k in data.files if k.endswith("lora_b"))
    ref = jax_apply(jm, params, jb, train=False)
    port = build_sam3_image_model(cfg, lora=lora)
    load_jax_params(port, {k: v for k, v in flat.items() if "lora_" not in k})
    assert load_lora_weights(port, path) == n
    T = torch.from_numpy
    with torch.no_grad():
        got = port(Batch(T(images), T(ids).long(), torch.zeros(2, dtype=torch.long),
                         GeoPrompt.empty(2, cfg.max_prompt_boxes)))
    for k in ("pred_logits", "pred_boxes", "presence_logit_dec", "pred_masks"):
        assert_close(got[k], ref[k], rtol=2e-4, atol=2e-4, name=k)


def test_cli_train_resumes_from_train_state(run):
    out = run["out"]
    result = cli_train.main(["--config", run["yaml"], "--device", "cpu", "--num-epochs", "3"])
    assert result["steps"] == 3 * STEPS_PER_EPOCH
    stats = _stats(out)
    resumed = [s for s in stats if s["step"] > 2 * STEPS_PER_EPOCH]
    assert [s["epoch"] for s in resumed] == [2] * STEPS_PER_EPOCH
    assert all(np.isfinite(s["loss"]) for s in resumed)
