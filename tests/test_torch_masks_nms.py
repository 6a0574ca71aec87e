"""The port's mask ops and mask NMS (``sam3_lora_tpu_torch/ops/masks.py``,
``ops/nms.py``) against the JAX package's on the CPU.

Tolerances: ``mask_iou`` and ``masks_to_boxes`` within 1e-6 absolute (both
compute the same fp32 expressions: an exact 0/1 product sum, one division);
the NMS keep mask bit for bit, tied scores and a ``valid`` mask included;
also ``chip_smoke.nms_device_loop``, the on-device loop that ``ops/nms.py``'s
host loop was measured against on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sam3_lora_tpu.ops import masks as jmasks
from sam3_lora_tpu.ops import nms as jnms
from sam3_lora_tpu_torch.ops import masks, nms

TOL = 1e-6
NMS = {"ops": nms.generic_nms_mask, "device-loop": chip_smoke.nms_device_loop}


def _masks(n, h, w, seed=0, empty=()):
    """``n`` seeded (h, w) masks: random boxes, some ragged blobs, and the
    indices in ``empty`` left empty."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        if i in empty:
            continue
        y0, x0 = rng.randint(0, h - 2), rng.randint(0, w - 2)
        y1, x1 = rng.randint(y0 + 1, h + 1), rng.randint(x0 + 1, w + 1)
        out[i, y0:y1, x0:x1] = True
        if i % 3 == 0:
            out[i] &= rng.rand(h, w) > 0.3
    return out


@pytest.mark.parametrize("h,w", [(16, 16), (17, 23)])
def test_mask_iou_matches_jax(h, w):
    a, b = _masks(7, h, w, 0, empty=(2,)), _masks(5, h, w, 1, empty=(4,))
    want = np.asarray(jmasks.mask_iou(jnp.asarray(a), jnp.asarray(b)))
    got = masks.mask_iou(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # float 0/1 input gives the same
    np.testing.assert_allclose(masks.mask_iou(torch.from_numpy(a).float(),
                                              torch.from_numpy(b).float()).numpy(),
                               want, rtol=0, atol=TOL)


@pytest.mark.parametrize("h,w", [(16, 16), (9, 31)])
def test_masks_to_boxes_matches_jax(h, w):
    m = _masks(6, h, w, 2, empty=(0, 5))
    m[3] = True  # a full mask
    want = np.asarray(jmasks.masks_to_boxes(jnp.asarray(m)))
    got = masks.masks_to_boxes(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert (got[0] == 0).all() and (got[5] == 0).all()
    assert got[3].tolist() == [0.0, 0.0, float(w), float(h)]


def _jax_keep(iou, scores, thr, valid=None):
    return np.asarray(jnms.generic_nms_mask(
        jnp.asarray(iou), jnp.asarray(scores), thr,
        valid=None if valid is None else jnp.asarray(valid)))


@pytest.mark.parametrize("impl", sorted(NMS))
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_generic_nms_matches_jax(impl, ties, with_valid):
    """Random symmetric IoU matrices at N = 60: the keep mask bit for bit,
    at three thresholds; with ``ties`` the scores take 5 values."""
    rng = np.random.RandomState(int(ties) * 2 + int(with_valid))
    n = 60
    x = rng.rand(n, n).astype(np.float32)
    iou = (x + x.T) / 2
    np.fill_diagonal(iou, 1.0)
    scores = (rng.randint(0, 5, n) / 4 if ties else rng.rand(n)).astype(np.float32)
    valid = rng.rand(n) > 0.2 if with_valid else None
    for thr in (0.3, 0.5, 0.8):
        want = _jax_keep(iou, scores, thr, valid)
        got = NMS[impl](torch.from_numpy(iou), torch.from_numpy(scores), thr,
                        valid=None if valid is None else torch.from_numpy(valid))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        if valid is not None:
            assert not got.numpy()[~valid].any()


def test_nms_masks_matches_jax_with_ties():
    """Mask NMS on overlapping masks whose scores tie in groups: JAX's
    stable argsort(-s) order decides who survives, and so does the port's."""
    m = _masks(40, 20, 24, 3, empty=(7,))
    m[10:20] = m[0]  # exact duplicates: IoU 1 against row 0
    scores = np.repeat(np.float32([0.9, 0.5, 0.5, 0.2]), 10)
    valid = np.ones(40, bool)
    valid[[1, 12]] = False
    for v in (None, valid):
        want = np.asarray(jnms.nms_masks(jnp.asarray(m), jnp.asarray(scores), 0.5,
                                         valid=None if v is None else jnp.asarray(v)))
        got = nms.nms_masks(torch.from_numpy(m), torch.from_numpy(scores), 0.5,
                            valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_order_is_jax_stable_argsort():
    """The rows in ``jnp.argsort(-s)``'s order (stable: ties keep their input
    order; invalid rows last), and only later rows in ``sup``."""
    s = np.float32([0.5, 0.9, 0.5, 0.1, 0.9, 0.5])
    valid = np.array([True, True, False, True, True, True])
    iou = torch.ones(6, 6)
    order, sup, alive = nms.greedy_order(iou, torch.from_numpy(s), 0.5, torch.from_numpy(valid))
    want = np.asarray(jnp.argsort(-jnp.where(jnp.asarray(valid), jnp.asarray(s), -jnp.inf)))
    np.testing.assert_array_equal(order.numpy(), want)
    assert order.tolist() == [1, 4, 0, 5, 3, 2]
    assert torch.equal(sup, torch.ones(6, 6, dtype=torch.bool).triu(1))
    assert alive.tolist() == [True, True, True, True, True, False]
