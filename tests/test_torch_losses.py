"""``compute_losses`` of the port against the JAX package's, on one training
output built with numpy (2 decoder layers: main and aux; DAC o2m outputs;
matched and unmatched targets, a non-exhaustive row, a row with no targets;
predicted masks at half the ground truth's resolution). Every key is compared. fp32;
tolerance 1e-5 relative (2e-5 absolute): the same formulas, summed in
another order. The focal/BCE/dice elementwise losses are checked on their
own as well, and the gradient of ``core_loss`` with respect to the predicted
logits, boxes and masks against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.models.sam3_image import Targets as JTargets
from sam3_lora_tpu.ops import focal as jfocal
from sam3_lora_tpu.train import losses as jl
from sam3_lora_tpu_torch.models import Targets
from sam3_lora_tpu_torch.ops import focal as pfocal
from sam3_lora_tpu_torch.ops.boxes import box_cxcywh_to_xyxy
from sam3_lora_tpu_torch.train import losses as pl

from torch_port_helpers import assert_close

L, B, Q, T, K, HM = 2, 3, 12, 5, 4, 8


def _boxes(rng, *shape):
    return np.concatenate([rng.uniform(0.2, 0.8, shape + (2,)),
                           rng.uniform(0.05, 0.4, shape + (2,))], -1).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    valid = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0], [0, 0, 0, 0, 0]], bool)
    tgt = dict(
        boxes=_boxes(rng, B, T) * valid[..., None],
        valid=valid,
        masks=(rng.uniform(size=(B, T, 2 * HM, 2 * HM)) < 0.3),
        mask_valid=valid & (rng.uniform(size=(B, T)) < 0.8),
        is_exhaustive=np.array([True, False, True]),
    )
    idx = np.stack([np.stack([rng.permutation(Q)[:T] for _ in range(B)]) for _ in range(L)])
    idx = np.where(valid[None], idx, -1)
    out = dict(
        pred_logits=rng.standard_normal((L, B, Q, 1)).astype(np.float32),
        pred_boxes=_boxes(rng, L, B, Q),
        presence_logit_dec=rng.standard_normal((L, B, 1)).astype(np.float32),
        indices=idx,
        pred_logits_o2m=rng.standard_normal((L, B, Q, 1)).astype(np.float32),
        pred_boxes_o2m=_boxes(rng, L, B, Q),
        o2m_indices=rng.randint(0, Q, (L, B, T, K)),
        o2m_valid=rng.uniform(size=(L, B, T, K)) < 0.6,
        pred_masks_matched=rng.standard_normal((B, T, HM, HM)).astype(np.float32),
        pred_masks_o2m_matched=rng.standard_normal((B, T, K, HM, HM)).astype(np.float32),
    )
    return out, tgt


def _xyxy(out, lib):
    out = dict(out)
    conv = box_cxcywh_to_xyxy if lib == "torch" else _jxyxy
    out["pred_boxes_xyxy"] = conv(out["pred_boxes"])
    out["pred_boxes_xyxy_o2m"] = conv(out["pred_boxes_o2m"])
    return out


def _jxyxy(b):
    from sam3_lora_tpu.ops.boxes import box_cxcywh_to_xyxy as j

    return j(b)


def _port_losses(out, tgt, grad=False):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}
    leaves = ("pred_logits", "pred_boxes", "pred_logits_o2m", "pred_boxes_o2m",
              "pred_masks_matched", "pred_masks_o2m_matched")
    if grad:
        for k in leaves:
            t[k].requires_grad_(True)
    targets = Targets(**{k: torch.from_numpy(v) for k, v in tgt.items()})
    losses = pl.compute_losses(_xyxy(t, "torch"), targets)
    if grad:
        losses["core_loss"].backward()
        return {k: t[k].grad.numpy() for k in leaves}
    return losses


def _jax_losses(out, tgt):
    targets = JTargets(**{k: jnp.asarray(v) for k, v in tgt.items()})
    j = {k: jnp.asarray(v) for k, v in out.items()}
    return jax.jit(lambda o: jl.compute_losses(_xyxy(o, "jax"), targets))(j)


def test_every_loss_term_matches_jax(case):
    out, tgt = case
    ref = _jax_losses(out, tgt)
    port = _port_losses(out, tgt)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert_close(port[k], ref[k], rtol=1e-5, atol=2e-5, name=k)
    assert float(ref["core_loss"]) > 0


def test_core_loss_gradients_match_jax(case):
    out, tgt = case
    targets = JTargets(**{k: jnp.asarray(v) for k, v in tgt.items()})
    names = ("pred_logits", "pred_boxes", "pred_logits_o2m", "pred_boxes_o2m",
             "pred_masks_matched", "pred_masks_o2m_matched")

    def core(leaves):
        o = {k: jnp.asarray(v) for k, v in out.items()}
        o.update(leaves)
        return jl.compute_losses(_xyxy(o, "jax"), targets)["core_loss"]

    ref = jax.jit(jax.grad(core))({k: jnp.asarray(out[k]) for k in names})
    port = _port_losses(out, tgt, grad=True)
    for k in names:
        scale = float(np.abs(np.asarray(ref[k])).max())
        assert_close(port[k], ref[k], rtol=1e-4, atol=1e-5 * scale, name=k)


def test_focal_bce_dice_match_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((4, 50)).astype(np.float32) * 4
    y = (rng.uniform(size=(4, 50)) < 0.4).astype(np.float32)
    T = torch.from_numpy
    assert_close(pfocal.sigmoid_bce(T(x), T(y)), jfocal.sigmoid_bce(x, y), rtol=1e-6, atol=1e-6)
    assert_close(pfocal.sigmoid_focal_loss(T(x), T(y), 0.25, 2.0),
                 jfocal.sigmoid_focal_loss(x, y, 0.25, 2.0), rtol=1e-6, atol=1e-6)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    assert_close(pfocal.dice_loss(T(x), T(y), 3.0, T(w)), jfocal.dice_loss(x, y, 3.0, w),
                 rtol=1e-6, atol=1e-6)
