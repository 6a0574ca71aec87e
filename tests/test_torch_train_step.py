"""The port's training step against the JAX package's, on the tiny config in
fp32 with the same numpy-seeded weights (a JAX init in the scanned layout,
nonzero adapters, through the weight bridge) and the same batch with
targets:

* every output key of the training forward (DAC o2m outputs, matching,
  matched masks) against JAX ``apply(train=True)``, the matching of the
  port's exact host solver included: on this step it equals JAX's default
  auction solver index for index;
* ``core_loss``, every per-term loss and every adapter gradient against
  ``jax.value_and_grad`` of the JAX trainer's loss (``trainer.py`` loss_fn);
* the adapters after 3 updates of the port's ``Trainer`` against 3 steps of
  the JAX trainer's ``make_train_step`` with its optax AdamW, clip and
  warmup-cosine schedule.

Dropout: the JAX and port RNG streams cannot match, so every rate is 0
(``tiny_model_config``), and the scorer MLP's fixed 0.1 is set to 0 on both
sides for this comparison; dropout is tested by its statistics in
``test_torch_train_dropout.py``. Tolerances: outputs 2e-4 (as the eval
forward's, ``test_torch_slice.py``), losses 1e-4 relative, gradients 2e-3 of
each gradient's largest entry (a backward through ~20 fp32 layers, sums in
another order), adapters after 3 AdamW updates: 99% of the entries within
1e-2 of the learning rate and every entry within half of it (Adam divides
by the gradient's running RMS, so where a gradient entry sits near Adam's
eps, a rounding-level difference moves its update by a fraction of lr).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, TrainConfig, tiny_model_config
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models import layers as jax_layers
from sam3_lora_tpu.models import scoring as jax_scoring
from sam3_lora_tpu.models.geometry import GeoPrompt as JGeoPrompt
from sam3_lora_tpu.models.sam3_image import Batch as JBatch
from sam3_lora_tpu.models.sam3_image import Targets as JTargets
from sam3_lora_tpu.train import trainer as jax_trainer
from sam3_lora_tpu.train.losses import LossConfig as JLossConfig
from sam3_lora_tpu.train.losses import compute_losses as jax_compute_losses
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, Targets, build_sam3_image_model
from sam3_lora_tpu_torch.models.lora import lora_state, trainable_parameters
from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer
from sam3_lora_tpu_torch.train.losses import compute_losses
from sam3_lora_tpu_torch.train.trainer import Trainer
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params, stack_scanned

from torch_port_helpers import assert_close, jax_apply, random_jax_params

TOL = 2e-4
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
STEPS = 3
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=1, num_epochs=1, max_grad_norm=1.0,
                   weight_decay=0.01, seed=0)


def _mlp_without_dropout(*args, dropout=0.0, **kwargs):
    return jax_layers.MLP(*args, dropout=0.0, **kwargs)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    r, t, m = cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    images = rng.standard_normal((2, 3, r, r)).astype(np.float32)
    ids = np.asarray(get_default_tokenizer()(["crack", "a small dog", "tree"],
                                             context_length=cfg.text_context_length))
    img_ids = np.array([0, 1, 0], np.int32)
    valid = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0], [1, 1, 0, 0, 0]], bool)[:, :t]
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (3, t, 2)), rng.uniform(0.1, 0.4, (3, t, 2))],
                           -1).astype(np.float32) * valid[..., None]
    masks = rng.uniform(size=(3, t, m, m)) < 0.3
    mask_valid = valid.copy()
    mask_valid[2, 1] = False
    exhaustive = np.array([True, False, True])
    geo = (np.zeros((3, cfg.max_prompt_boxes, 4), np.float32),
           np.ones((3, cfg.max_prompt_boxes), bool),
           np.ones((3, cfg.max_prompt_boxes), np.int32))
    J = jnp.asarray
    jb = JBatch(images=J(images), token_ids=J(ids), img_ids=J(img_ids), geo=JGeoPrompt(*map(J, geo)),
                targets=JTargets(J(boxes), J(valid), J(masks), J(mask_valid), J(exhaustive)))
    T = torch.from_numpy
    tb = Batch(images=T(images), token_ids=T(ids).long(), img_ids=T(img_ids).long(),
               geo=GeoPrompt(T(geo[0]), T(geo[1]), T(geo[2]).long()),
               targets=Targets(T(boxes), T(valid), T(masks), T(mask_valid), T(exhaustive)))
    return jb, tb


def _jax_loss_fn(jm):
    # the loss of sam3_lora_tpu/train/trainer.py::make_train_step
    def loss_fn(trainable, frozen, mb, rng):
        params = jax_trainer.merge_trainable(trainable, frozen)
        out = jm.apply({"params": params}, mb, train=True, rngs={"dropout": rng})
        losses = jax_compute_losses(out, mb.targets, JLossConfig())
        return losses["core_loss"], losses

    return loss_fn


def _adapter_grads_jax_layout(model, cfg):
    """The adapters' .grad under the JAX names, layout and channel order."""
    params = trainable_parameters(model)
    saved = [p.detach().clone() for _, p in params]
    with torch.no_grad():
        for _, p in params:
            p.copy_(p.grad)
    grads = stack_scanned(lora_state(model), cfg)
    with torch.no_grad():
        for (_, p), s in zip(params, saved):
            p.copy_(s)
    return grads


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_scoring, "MLP", _mlp_without_dropout)
    try:
        cfg = tiny_model_config()
        jm = build_jax(cfg, lora=LORA)
        jb, tb = _batch(cfg)
        params, flat = random_jax_params(jm, dataclasses.replace(jb, targets=None), train=False)
        ref_out = jax_apply(jm, params, jb, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
        trainable, frozen = jax_trainer.split_trainable(params)
        (ref_loss, ref_losses), ref_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jm), has_aux=True))(
            trainable, frozen, jb, jax.random.PRNGKey(1))

        tx, _ = jax_trainer.make_optimizer(TCFG, steps_per_epoch=STEPS)
        jstep = jax_trainer.make_train_step(jm, tx, JLossConfig())
        opt_state = tx.init(trainable)
        jt = dict(trainable)
        for i in range(STEPS):
            jt, opt_state, _ = jstep(jt, frozen, opt_state, jb, jax.random.PRNGKey(i))
        ref_after = {".".join(k): np.asarray(v) for k, v in jt.items()}
        ref_grads = {".".join(k): np.asarray(v) for k, v in ref_grads.items()}
    finally:
        mp.undo()

    port = build_sam3_image_model(cfg, lora=LORA)
    load_jax_params(port, flat)
    port.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    trainable_parameters(port)
    port.train()
    out = port(tb)
    losses = compute_losses(out, tb.targets)
    losses["core_loss"].backward()
    grads = _adapter_grads_jax_layout(port, cfg)

    ckpt = str(tmp_path_factory.mktemp("base") / "base.npz")
    np.savez(ckpt, **flat)
    trainer = Trainer(cfg, LORA, dataclasses.replace(TCFG, output_dir=os.path.dirname(ckpt)),
                      base_checkpoint=ckpt, device="cpu")
    trainer.setup(steps_per_epoch=STEPS)
    trainer.model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0
    for _ in range(STEPS):
        trainer.train_step(tb)
    after = stack_scanned(lora_state(trainer.model), cfg)
    return dict(cfg=cfg, out=out, ref_out=ref_out, losses=losses, ref_losses=ref_losses,
                ref_loss=ref_loss, grads=grads, ref_grads=ref_grads, after=after,
                ref_after=ref_after, before={k: v for k, v in flat.items() if "lora_" in k})


def test_training_forward_matches_jax_every_key(step):
    out, ref = step["out"], step["ref_out"]
    assert set(out) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert out[k] is None, k
        elif k in ("prompt_mask", "indices", "o2m_indices", "o2m_valid"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
        else:
            assert tuple(out[k].shape) == tuple(ref[k].shape), k
            assert_close(out[k], ref[k], rtol=TOL, atol=TOL, name=k)
    assert (np.asarray(ref["indices"]) >= 0).any()


def test_losses_match_jax(step):
    losses, ref = step["losses"], step["ref_losses"]
    assert sorted(losses) == sorted(ref)
    for k in ref:
        assert_close(losses[k], ref[k], rtol=1e-4, atol=1e-5, name=k)
    assert_close(losses["core_loss"], step["ref_loss"], rtol=1e-4, atol=1e-5)


def test_adapter_gradients_match_jax(step):
    grads, ref = step["grads"], step["ref_grads"]
    assert sorted(grads) == sorted(ref) and len(ref) > 0
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        assert scale > 0, k
        assert_close(grads[k], ref[k], rtol=0, atol=2e-3 * scale, name=k)


def test_adapters_after_three_updates_match_optax(step):
    after, ref, before = step["after"], step["ref_after"], step["before"]
    assert sorted(after) == sorted(ref)
    lr = TCFG.learning_rate
    errs = np.concatenate([np.abs(after[k] - ref[k]).ravel() for k in ref])
    moved = np.concatenate([np.abs(ref[k] - before[k]).ravel() for k in ref])
    assert np.quantile(errs, 0.99) <= 1e-2 * lr, np.quantile(errs, 0.99)
    assert errs.max() <= 0.5 * lr, errs.max()
    assert moved.max() > 0.5 * lr  # the updates are well above the tolerance
