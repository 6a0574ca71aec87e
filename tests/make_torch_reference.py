"""Write the JAX package's reference outputs of the tiny config for the
port's whole-model tests (``tests/test_torch_reference.py``):

    JAX_PLATFORMS=cpu python tests/make_torch_reference.py [out_dir] [case ...]

writes ``torch_ref_<case>.npz`` into ``out_dir`` (default ``tests/data``) for
seven cases: the eval forward and the training step, each with the base in
fp32 (``base_quant="none"``), in the int8 tier (``base_quant="int8"``,
``base_quant_min_dim=16``, the frozen base quantized by the JAX package's
``prequantize_tree`` / ``prequantize_base``), and at ``bench.py``'s settings
(``_bench``: the int8 tier over a base stored in bf16, ``wo_block_mid`` ViT
remat, ``enc_remat_ffn``, flat ViT blocks, the bench adapter targets at rank
4 with the geometry encoder and mask decoder on; ``d_model`` 16 and the int8
gate at 32, so that, as in the full config, the ViT and the text encoder are
quantized and the detection heads are not; their forward runs op by op, see
``reference``). Compute is fp32 in every
case, with LoRA rank 4 (on qkv/fc1/fc2/linear1/linear2 but for the bench
cases), weights drawn from numpy seed 0 (``torch_port_helpers.fill_params``,
rounded to bf16 where the base is stored so) and a numpy-seeded batch.

The seventh, ``train_int8_fsdp`` (``tests/test_torch_fsdp.py``), is the
training step of the int8 tier with the frozen base sharded, as
``tests/test_quant.py``'s multichip step composes it: the parameters placed
by ``param_shardings(..., shard_base=True)`` on the (4, 2) mesh of the 8
CPU devices, then the frozen base prequantized, over 8 images and 8 prompts
(one an image) in two microbatches of 4 (accumulation 2), each on the mesh
by ``shard_batch``; the losses and gradients are the means of the two
microbatches'. It also holds the same step with each microbatch replicated
on the mesh (``replicated/``): in the int8 tier, splitting the batch moves
some activations by an int8 step in JAX's jitted program (see
``tests/test_torch_fsdp.py``). The script gives JAX its 8 CPU devices before
importing it.

Each file holds what the port needs to rebuild the inputs without JAX and
the outputs to compare: ``params`` (a JSON list of [name, shape] in draw
order), ``in/<field>`` (the batch), ``out/<key>`` (every non-None output of
``Sam3Image``; ``none_keys`` lists the rest), for the int8 eval forward
``quant/<leaf>`` (the int8 kernels and scales ``prequantize_base`` wrote),
and for training ``loss/<term>`` and ``grad/<adapter>`` (JAX layout and
names) from ``jax.value_and_grad`` of the JAX trainer's loss. The training step runs with every dropout rate at 0
(the scorer MLP's fixed 0.1 included): the two packages' random streams
differ.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import traverse_util  # noqa: E402

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config  # noqa: E402
from sam3_lora_tpu.models import build_sam3_image_model  # noqa: E402
from sam3_lora_tpu.models import layers as jax_layers  # noqa: E402
from sam3_lora_tpu.models import scoring as jax_scoring  # noqa: E402
from sam3_lora_tpu.models.geometry import GeoPrompt  # noqa: E402
from sam3_lora_tpu.models.sam3_image import Batch, Targets  # noqa: E402
from sam3_lora_tpu.models.tokenizer import get_default_tokenizer  # noqa: E402
from sam3_lora_tpu.ops.quant import prequantize_base  # noqa: E402
from sam3_lora_tpu.parallel import make_mesh, param_shardings, replicated, shard_batch  # noqa: E402
from sam3_lora_tpu.train import trainer as jax_trainer  # noqa: E402
from sam3_lora_tpu.train.losses import LossConfig, compute_losses  # noqa: E402

from torch_port_helpers import fill_params, jax_apply, param_specs  # noqa: E402

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
CASES = {  # name -> (training step, config overrides)
    "eval": (False, {}),
    "eval_int8": (False, QUANT),
    "train": (True, {}),
    "train_int8": (True, QUANT),
    "eval_bench": (False, BENCH),
    "train_bench": (True, BENCH),
    "train_int8_fsdp": (True, QUANT),
}
FSDP_ACCUM, FSDP_IMAGES = 2, 8  # two microbatches of 4: one image a data index
FSDP_PROMPTS = ("crack", "a small dog", "tree", "wall", "stain", "rust", "a red car", "leaf")


def case_config(name: str):
    return tiny_model_config(**CASES[name][1])


def case_lora(name: str) -> LoRAConfig:
    return LORA_BENCH if name.endswith("bench") else LORA


def make_batch(cfg, with_targets: bool) -> dict:
    """Numpy arrays of one batch: two images, three prompts (one a dog on
    image 1), box prompts with padding, and for training padded targets."""
    rng = np.random.RandomState(0)
    r, t, m = cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    arrays = {
        "images": rng.standard_normal((2, 3, r, r)).astype(np.float32),
        "token_ids": np.asarray(get_default_tokenizer()(
            ["crack", "a small dog", "tree"], context_length=cfg.text_context_length)),
        "img_ids": np.array([0, 1, 0], np.int32),
        "geo_boxes": np.array([[[0.5, 0.5, 0.4, 0.3], [0, 0, 0, 0]],
                               [[0.3, 0.6, 0.5, 0.7], [0.7, 0.2, 0.2, 0.1]],
                               [[0, 0, 0, 0], [0, 0, 0, 0]]], np.float32),
        "geo_mask": np.array([[False, True], [False, False], [True, True]]),
        "geo_labels": np.array([[1, 1], [1, 0], [1, 1]], np.int32),
    }
    if with_targets:
        valid = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0], [1, 1, 0, 0, 0]], bool)[:, :t]
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (3, t, 2)), rng.uniform(0.1, 0.4, (3, t, 2))],
                               -1).astype(np.float32) * valid[..., None]
        mask_valid = valid.copy()
        mask_valid[2, 1] = False
        arrays.update(boxes=boxes, valid=valid, masks=rng.uniform(size=(3, t, m, m)) < 0.3,
                      mask_valid=mask_valid, is_exhaustive=np.array([True, False, True]))
    return arrays


def make_fsdp_batch(cfg) -> dict:
    """Numpy arrays of the sharded step's batch: FSDP_IMAGES images, one
    prompt each (``img_ids`` 0..7), box prompts with padding, padded
    targets with at least one box a prompt."""
    rng = np.random.RandomState(1)
    n, r, t, m = FSDP_IMAGES, cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    valid = rng.uniform(size=(n, t)) < 0.5
    valid[:, 0] = True
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (n, t, 2)), rng.uniform(0.1, 0.4, (n, t, 2))],
                           -1).astype(np.float32) * valid[..., None]
    geo_mask = rng.uniform(size=(n, 2)) < 0.5
    return {
        "images": rng.standard_normal((n, 3, r, r)).astype(np.float32),
        "token_ids": np.asarray(get_default_tokenizer()(
            list(FSDP_PROMPTS), context_length=cfg.text_context_length)),
        "img_ids": np.arange(n, dtype=np.int32),
        "geo_boxes": (rng.uniform(0.2, 0.8, (n, 2, 4)) * ~geo_mask[..., None]).astype(np.float32),
        "geo_mask": geo_mask,
        "geo_labels": rng.randint(0, 2, (n, 2)).astype(np.int32),
        "boxes": boxes, "valid": valid, "masks": rng.uniform(size=(n, t, m, m)) < 0.3,
        "mask_valid": valid & (rng.uniform(size=(n, t)) < 0.8),
        "is_exhaustive": rng.uniform(size=n) < 0.5,
    }


def fsdp_step(jm, cfg, params, arrays: dict) -> dict:
    """The sharded step's mean losses and gradients (module docstring):
    ``loss/``, ``grad/`` with each microbatch split over the data axis, as
    ``tests/test_quant.py`` places it; ``replicated/loss/``,
    ``replicated/grad/`` with the same base placement and each microbatch
    whole on every device."""
    mesh = make_mesh(n_devices=8, model_parallel=2)
    per = FSDP_IMAGES // FSDP_ACCUM
    rng = jax.random.PRNGKey(1)

    def loss_fn(trainable, frozen, jb):
        o = jm.apply({"params": jax_trainer.merge_trainable(trainable, frozen)}, jb, train=True,
                     rngs={"dropout": rng})
        losses = compute_losses(o, jb.targets, LossConfig())
        return losses["core_loss"], losses

    loss_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    total = {}
    with mesh:
        params = jax.device_put(params, param_shardings(params, mesh, shard_base=True))
        trainable, frozen = jax_trainer.split_trainable(params)
        frozen = prequantize_base(frozen, min_dim=cfg.base_quant_min_dim)
        for i in range(FSDP_ACCUM):
            mb = {k: v[i * per:(i + 1) * per] for k, v in arrays.items()}
            mb["img_ids"] = np.arange(per, dtype=np.int32)
            for prefix, place in (("", shard_batch),
                                  ("replicated/", lambda b, m: jax.device_put(b, replicated(m)))):
                (_, losses), grads = loss_and_grad(trainable, frozen, place(jax_batch(mb), mesh))
                for k, v in losses.items():
                    total[f"{prefix}loss/{k}"] = total.get(f"{prefix}loss/{k}", 0) + np.asarray(v)
                for k, v in grads.items():
                    key = f"{prefix}grad/{'.'.join(k)}"
                    total[key] = total.get(key, 0) + np.asarray(v)
    return {k: v / FSDP_ACCUM for k, v in total.items()}


def jax_batch(arrays: dict) -> Batch:
    J = jnp.asarray
    targets = None
    if "boxes" in arrays:
        targets = Targets(*(J(arrays[k]) for k in ("boxes", "valid", "masks", "mask_valid",
                                                   "is_exhaustive")))
    return Batch(images=J(arrays["images"]), token_ids=J(arrays["token_ids"]),
                 img_ids=J(arrays["img_ids"]),
                 geo=GeoPrompt(J(arrays["geo_boxes"]), J(arrays["geo_mask"]), J(arrays["geo_labels"])),
                 targets=targets)


def _mlp_without_dropout(*args, dropout=0.0, **kwargs):
    return jax_layers.MLP(*args, dropout=0.0, **kwargs)


def reference(name: str) -> dict:
    """The arrays of one case's file."""
    train, _ = CASES[name]
    cfg = case_config(name)
    lora = case_lora(name)
    jm = build_sam3_image_model(cfg, lora=lora)
    arrays = make_batch(cfg, with_targets=train)
    jb = jax_batch(arrays)
    example = jax_batch(make_batch(cfg, with_targets=False))
    specs = param_specs(jm, example, train=False)
    flat = fill_params(specs)
    dtypes = traverse_util.flatten_dict(jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, example, train=False))["params"])
    params = traverse_util.unflatten_dict(
        {p: jnp.asarray(flat[".".join(p)]).astype(dtypes[p].dtype) for p, _ in specs})
    trainable, frozen = jax_trainer.split_trainable(params)
    out = {"params": np.asarray(json.dumps([[".".join(p), list(s)] for p, s in specs]))}
    if name.endswith("fsdp"):
        arrays = make_fsdp_batch(cfg)
        out.update({f"in/{k}": v for k, v in arrays.items()})
        orig = jax_scoring.MLP
        jax_scoring.MLP = _mlp_without_dropout
        try:
            out.update(fsdp_step(build_sam3_image_model(cfg, lora=lora), cfg, params, arrays))
        finally:
            jax_scoring.MLP = orig
        return out
    if cfg.base_quant != "none":
        quantized = prequantize_base(frozen, min_dim=cfg.base_quant_min_dim)
        if not train:  # the leaves prequantize_base changed, for the bridge's test
            out.update({f"quant/{'.'.join(k)}": np.asarray(v) for k, v in quantized.items()
                        if v is not frozen[k]})
        frozen = quantized
    params = jax_trainer.merge_trainable(trainable, frozen)
    out.update({f"in/{k}": v for k, v in arrays.items()})
    # the bench cases' forward runs op by op, as the port quantizes: under
    # jax.jit XLA multiplies by 1/127 where the JAX code divides (PERF.md,
    # PR 3), and on their inputs that moves some activations by an int8 step
    op_by_op = jax.disable_jit(name.endswith("bench"))
    if not train:
        with op_by_op:
            ref = jax_apply(jm, params, jb, train=False)
    else:
        orig = jax_scoring.MLP
        jax_scoring.MLP = _mlp_without_dropout
        try:
            jm = build_sam3_image_model(cfg, lora=lora)
            rng = jax.random.PRNGKey(1)
            with op_by_op:
                ref = jax_apply(jm, params, jb, train=True, rngs={"dropout": rng})

            def loss_fn(trainable, frozen):
                p = jax_trainer.merge_trainable(trainable, frozen)
                o = jm.apply({"params": p}, jb, train=True, rngs={"dropout": rng})
                losses = compute_losses(o, jb.targets, LossConfig())
                return losses["core_loss"], losses

            (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable, frozen)
        finally:
            jax_scoring.MLP = orig
        out.update({f"loss/{k}": np.asarray(v) for k, v in losses.items()})
        out.update({f"grad/{'.'.join(k)}": np.asarray(v) for k, v in grads.items()})
    out["none_keys"] = np.asarray(json.dumps(sorted(k for k, v in ref.items() if v is None)))
    out.update({f"out/{k}": np.asarray(v) for k, v in ref.items() if v is not None})
    return out


def write(out_dir: str, names=tuple(CASES)) -> list:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in names:
        path = os.path.join(out_dir, f"torch_ref_{name}.npz")
        np.savez_compressed(path, **reference(name))
        paths.append(path)
    return paths


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "data")
    for p in write(out, tuple(sys.argv[2:]) or tuple(CASES)):
        print(p, os.path.getsize(p))
