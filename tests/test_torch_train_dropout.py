"""Dropout in the port's training mode, tested by its statistics (the JAX
and port RNG streams cannot match), and its interplay with remat:

* ``Dropout``: keep rate within 10 binomial standard deviations of 1 - rate,
  kept values scaled by exactly 1/keep, identity in eval mode or at rate 0,
  an error when the model's generator was never seeded;
* ``DropPath``: one draw per sample (a row is all dropped or all kept);
* LoRA input dropout touches the adapter's input only;
* attention-probability dropout (plain and in-loop separable-bias paths):
  the mean over many draws approaches the undropped output;
* remat: with every rate above zero, the adapter gradients of a training
  step with ``torch.utils.checkpoint`` active equal those with it replaced
  by a plain call (1e-6 relative: the replay recomputes the same fp32 ops),
  so the backward's replay drew the same masks as the forward.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, Targets, build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.layers import Dropout, DropoutRNG, DropPath, LoRALinear, Spec
from sam3_lora_tpu_torch.models.lora import trainable_parameters
from sam3_lora_tpu_torch.ops.attention import dot_product_attention
from sam3_lora_tpu_torch.ops.rpb_attention import separable_bias_attention
from sam3_lora_tpu_torch.train.losses import compute_losses


def _spec(seed=0, lora=None):
    spec = Spec(model=tiny_model_config(), lora=lora)
    spec.rng.seed(seed, "cpu")
    return spec


def test_dropout_keep_rate_and_scaling():
    rate, n = 0.3, 200_000
    drop = Dropout(rate, _spec()).train()
    y = drop(torch.ones(n))
    kept = y != 0
    sd = math.sqrt(rate * (1 - rate) / n)
    assert abs(kept.float().mean().item() - (1 - rate)) < 10 * sd
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    x = torch.randn(50)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0, _spec()).train()(x), x)
    with pytest.raises(RuntimeError, match="seeded"):
        Dropout(rate, Spec(model=tiny_model_config())).train()(x)


def test_drop_path_drops_whole_samples():
    rate, n = 0.25, 4000
    y = DropPath(rate, _spec(1)).train()(torch.ones(n, 3, 5))
    flat = y.reshape(n, -1)
    dropped = (flat == 0).all(1)
    kept = (flat == 1 / (1 - rate)).all(1)
    assert bool((dropped | kept).all())
    assert abs(dropped.float().mean().item() - rate) < 10 * math.sqrt(rate * (1 - rate) / n)


def test_lora_dropout_touches_only_the_adapter_input():
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.5)
    spec = _spec(2, lora)
    lin = LoRALinear(16, 8, spec)
    lin.init_parameters(torch.Generator().manual_seed(0))
    lin.add_adapter(4, 8.0)
    lin.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(64, 16)
    with torch.no_grad():
        lin.lora_b.zero_()  # no adapter contribution: the base path is untouched
        assert torch.equal(lin.train()(x), lin.eval()(x))
        lin.lora_b.normal_(generator=torch.Generator().manual_seed(1))
        base = F.linear(x, lin.weight, lin.bias)
        ref = lin.eval()(x) - base
        mean = torch.stack([lin.train()(x) - base for _ in range(2000)]).mean(0)
    assert not torch.equal(lin.train()(x), lin.eval()(x))
    # the mean adapter delta over 2000 draws, within 5% of its scale
    assert (mean - ref).abs().max() < 0.05 * ref.abs().max()


def _attention_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(1, 2, 6, 8, generator=g) for _ in range(3))
    return q, k, v


def test_attention_prob_dropout_mean_approaches_undropped():
    q, k, v = _attention_inputs(3)
    rng = DropoutRNG()
    rng.seed(3, "cpu")
    ref = dot_product_attention(q, k, v)
    n = 2000  # draws, as rows of one batch
    many = dot_product_attention(*(t.expand(n, *t.shape[1:]) for t in (q, k, v)),
                                 dropout=0.2, rng=rng)
    assert not torch.equal(many[0], ref[0])
    assert (many.mean(0) - ref[0]).abs().max() < 0.05 * ref.abs().max()


def test_separable_bias_in_loop_dropout_mean_approaches_undropped():
    g = torch.Generator().manual_seed(4)
    gh = gw = 4
    q = torch.randn(1, 2, 5, 8, generator=g)
    k, v = (torch.randn(1, 2, gh * gw, 8, generator=g) for _ in range(2))
    dy, dx = torch.randn(1, 5, gh, 2, generator=g), torch.randn(1, 5, gw, 2, generator=g)
    rng = DropoutRNG()
    rng.seed(4, "cpu")
    kw = dict(grid_hw=(gh, gw), rows=2)
    ref = separable_bias_attention(q, k, v, dy, dx, **kw)
    n = 1000  # draws, as rows of one batch: each row gets its own masks
    with torch.no_grad():
        many = separable_bias_attention(*(t.expand(n, *t.shape[1:]) for t in (q, k, v, dy, dx)),
                                        dropout=0.2, rng=rng, **kw)
    assert (many.mean(0) - ref[0]).abs().max() < 0.05 * ref.abs().max()


def _training_batch(cfg):
    rng = np.random.RandomState(0)
    r, t, m = cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    valid = np.zeros((2, t), bool)
    valid[0, :2] = valid[1, 0] = True
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (2, t, 2)), rng.uniform(0.1, 0.4, (2, t, 2))], -1)
    T = torch.from_numpy
    ids = torch.zeros((2, cfg.text_context_length), dtype=torch.long)
    ids[:, 0], ids[:, 1], ids[:, 2] = 49406, 320, 49407
    return Batch(
        images=T(rng.standard_normal((2, 3, r, r)).astype(np.float32)), token_ids=ids,
        img_ids=torch.arange(2), geo=GeoPrompt.empty(2, cfg.max_prompt_boxes),
        targets=Targets(T((boxes * valid[..., None]).astype(np.float32)), T(valid),
                        T(rng.uniform(size=(2, t, m, m)) < 0.3), T(valid),
                        torch.ones(2, dtype=torch.bool)),
    )


def _adapter_grads(model, batch, seed):
    model.zero_grad(set_to_none=True)
    model.seed_dropout(seed)
    losses = compute_losses(model(batch), batch.targets)
    losses["core_loss"].backward()
    return losses["core_loss"].item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                        if p.grad is not None}


def test_remat_replays_the_same_dropout_masks(monkeypatch):
    cfg = tiny_model_config(vit_drop_path_rate=0.3, enc_dropout=0.2, dec_dropout=0.2)
    lora = LoRAConfig(rank=4, alpha=8.0, dropout=0.2,
                      target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
    model = build_sam3_image_model(cfg, lora=lora)
    init_model(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    trainable_parameters(model)
    model.train()
    batch = _training_batch(cfg)
    loss, remat = _adapter_grads(model, batch, seed=5)
    other_loss, _ = _adapter_grads(model, batch, seed=6)
    assert other_loss != loss  # the masks are live and follow the seed
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain_loss, plain = _adapter_grads(model, batch, seed=5)
    assert plain_loss == pytest.approx(loss, rel=1e-6)
    assert sorted(plain) == sorted(remat) and len(plain) > 0
    for name in plain:
        scale = plain[name].abs().max().item()
        assert (remat[name] - plain[name]).abs().max().item() <= 1e-6 * scale + 1e-12, name
