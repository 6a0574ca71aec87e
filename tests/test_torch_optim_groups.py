"""The port's grouped optimizer (``sam3_lora_tpu_torch/train/optim.py``)
against the JAX package's ``make_grouped_optimizer`` on the tiny image model
(unscanned ViT, LoRA on qkv/fc1/fc2/linear1/linear2):

* ``jax_path`` gives every port parameter the JAX path of the same leaf;
* the labels are equal for every parameter, with and without layer decay,
  for pattern groups written against the JAX paths ('/' and '.' both);
* two patterns of one group matching one parameter raise, in both;
* 3 AdamW updates of the adapters under a warmup-cosine schedule, with given
  gradients large enough that the global-norm clip acts, land within 1e-6
  of optax's (fp32, absolute and relative), parameter for parameter.

The JAX side (the parameter paths and shapes from ``jax.eval_shape`` of the
JAX model's init, its labels, optax's three updates) is stored in
``tests/data/torch_ref_optim.npz``; ``test_reference_is_current`` (slow)
recomputes it. Rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_optim_groups.py``."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.train import optim
from sam3_lora_tpu_torch.utils.checkpoint import _fold_out_perm, params_from_jax

TARGETS = ("qkv", "fc1", "fc2", "linear1", "linear2")
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_optim.npz")
KW = dict(groups=None, weight_decay=0.05, num_vit_layers=4)
DECAYS = (None, 0.8)
GROUPS = [
    {"name": "heads", "patterns": ["*dot_prod_scoring*", "*segmentation_head/*"], "lr_scale": 2.0},
    {"patterns": ["*/blocks.1/*", "*trunk/blocks.3/mlp*"], "lr_scale": 0.5, "weight_decay": 0.0},
    {"patterns": ["transformer.decoder/layers.0/*lora_*"], "weight_decay": 0.1},
]


def live_specs():
    """{JAX path tuple: shape} of the tiny image model's params."""
    import jax
    from flax import traverse_util

    from sam3_lora_tpu.models import build_sam3_image_model as build_jax
    from sam3_lora_tpu.models.builder import dummy_batch

    cfg = tiny_model_config(vit_scan_blocks=False)
    jm = build_jax(cfg, lora=LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, dummy_batch(cfg),
                                            train=False))["params"]
    return {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(shapes).items()}


def schedule():
    import optax

    return optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup_steps=1, decay_steps=5,
                                              end_value=3e-5)


def step_inputs(specs):
    """The adapters' start values and 3 steps of gradients, large enough
    that the clip acts."""
    ad = {k: s for k, s in specs.items() if k[-1] in ("lora_a", "lora_b")}
    rng = np.random.RandomState(0)
    values = {k: rng.standard_normal(s).astype(np.float32) for k, s in ad.items()}
    grads = [{k: 3.0 * rng.standard_normal(s).astype(np.float32) for k, s in ad.items()}
             for _ in range(3)]
    return values, grads


def jax_reference():
    """-> (specs, {layer decay: labels by path}, the adapters after optax's 3 updates)."""
    import jax.numpy as jnp
    import optax

    from sam3_lora_tpu.train import optim as joptim

    specs = live_specs()
    flat = {k: np.zeros(s, np.float32) for k, s in specs.items()}
    labels = {}
    for decay in DECAYS:
        _, lab = joptim.make_grouped_optimizer(flat, lambda step: 1e-3, **dict(
            KW, groups=GROUPS, layer_decay=decay))
        labels[str(decay)] = {optim.path_str(k): v for k, v in lab.items()}
    values, grads = step_inputs(specs)
    tx, _ = joptim.make_grouped_optimizer(values, schedule(), **dict(
        KW, groups=GROUPS, layer_decay=0.8, max_grad_norm=1.0))
    params = {k: jnp.asarray(v) for k, v in values.items()}
    state = tx.init(params)
    for gs in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, state, params)
        params = optax.apply_updates(params, upd)
    return specs, labels, {k: np.asarray(v) for k, v in params.items()}


def write_reference(path: str = REF) -> str:
    specs, labels, stepped = jax_reference()
    meta = {"specs": [[list(k), list(s)] for k, s in specs.items()], "labels": labels}
    np.savez(path, meta=json.dumps(meta), **{optim.path_str(k): v for k, v in stepped.items()})
    return path


@functools.lru_cache(maxsize=1)
def stored():
    with np.load(REF) as data:
        meta = json.loads(str(data["meta"]))
        specs = {tuple(k): tuple(s) for k, s in meta["specs"]}
        stepped = {k: data[optim.path_str(k)] for k in specs if optim.path_str(k) in data.files}
    return specs, meta["labels"], stepped


def port_model():
    m = build_sam3_image_model(tc.tiny_model_config(),
                               tc.LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS),
                               device="cpu")
    for n, p in m.named_parameters():
        p.requires_grad_("lora_" in n)
    return m


def test_jax_path_of_every_parameter():
    specs, _, _ = stored()
    m = port_model()
    assert {optim.jax_path(m, n) for n, _ in m.named_parameters()} == \
        {optim.path_str(k) for k in specs}


def check_labels(m, labels, opt, want):
    got = {optim.jax_path(m, n): lab for n, lab in labels.items()}
    assert got == want
    assert len(set(got.values())) >= 4
    assert {g["label"] for g in opt.param_groups} == set(got.values())
    for g in opt.param_groups:  # one group per label, its scale and decay parsed from it
        _, s, wd = g["label"].split("|")
        assert (float(s), float(wd)) == pytest.approx((g["lr_scale"], g["weight_decay"]), rel=1e-5)


@pytest.mark.parametrize("layer_decay", DECAYS)
def test_labels_match_jax(layer_decay):
    _, labels, _ = stored()
    m = port_model()
    opt, got = optim.make_grouped_optimizer(m, lambda step: 1e-3, params=m.named_parameters(),
                                            **dict(KW, groups=GROUPS, layer_decay=layer_decay))
    check_labels(m, got, opt, labels[str(layer_decay)])


def test_overlapping_patterns_raise():
    from sam3_lora_tpu.train import optim as joptim

    groups = [{"patterns": ["*qkv*", "*qkv/lora_a"]}]
    flat = {("trunk", "blocks.0", "attn", "qkv", "lora_a"): np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="matched 2 patterns"):
        joptim.make_grouped_optimizer(flat, lambda step: 1e-3, groups=groups)
    with pytest.raises(ValueError, match="matched 2 patterns"):
        optim.make_grouped_optimizer(port_model(), lambda step: 1e-3, groups=groups)


def port_stepped(specs):
    """The port's adapters after 3 updates from ``step_inputs``, by port name."""
    values, grads = step_inputs(specs)
    m = port_model()

    def port_layout(flat):
        t = params_from_jax({".".join(k): v for k, v in flat.items()})
        _fold_out_perm(m, t)
        return t

    with torch.no_grad():
        for name, t in port_layout(values).items():
            m.get_parameter(name).copy_(t)
    sched = schedule()
    opt, _ = optim.make_grouped_optimizer(m, lambda step: float(sched(step)), **dict(
        KW, groups=GROUPS, layer_decay=0.8, max_grad_norm=1.0))
    assert all(np.sqrt(sum((g ** 2).sum() for g in gs.values())) > 1.0 for gs in grads)
    for step, gs in enumerate(grads):
        for name, g in port_layout(gs).items():
            m.get_parameter(name).grad = g.clone()
        opt.update(step)
    return m, port_layout


def check_stepped(m, port_layout, stepped):
    want = port_layout(stepped)
    assert set(want) == {n for n, p in m.named_parameters() if p.requires_grad}
    for name, w in want.items():
        np.testing.assert_allclose(m.get_parameter(name).detach().numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_three_updates_match_optax():
    specs, _, stepped = stored()
    check_stepped(*port_stepped(specs), stepped)


def test_reference_is_current():
    specs, labels, stepped = jax_reference()
    s_specs, s_labels, s_stepped = stored()
    assert specs == s_specs and labels == s_labels
    assert sorted(stepped) == sorted(s_stepped)
    for k in stepped:
        np.testing.assert_array_equal(stepped[k], s_stepped[k])
    check_stepped(*port_stepped(specs), stepped)


if __name__ == "__main__":
    print(write_reference())
