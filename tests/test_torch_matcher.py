"""The port's matchers against the JAX package's, on random predictions and
padded targets made with numpy:

* the focal Hungarian cost (fp32, 1e-5 relative: the same formula);
* the exact one-to-one assignment (scipy on the host) equals JAX's exact
  Jonker-Volgenant solver index for index (random costs have one optimum);
* its total cost is at most that of JAX's default auction solver, which is
  optimal only to within T * 2e-3 of the cost range;
* the DAC one-to-many top-k, indices and validity, equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.train import matcher as jm
from sam3_lora_tpu_torch.train import matcher as pm

from torch_port_helpers import assert_close

_jv = jax.jit(functools.partial(jm.hungarian_match, algorithm="jv"))


def _problem(seed, b=3, q=20, t=6, layers=2):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((layers, b, q, 1)).astype(np.float32) * 2
    cxcy = rng.uniform(0.2, 0.8, (layers, b, q, 2))
    wh = rng.uniform(0.05, 0.4, (layers, b, q, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    tb = np.concatenate([rng.uniform(0.2, 0.8, (b, t, 2)), rng.uniform(0.05, 0.4, (b, t, 2))],
                        -1).astype(np.float32)
    valid = rng.uniform(size=(b, t)) < 0.7
    valid[:, 0] = True
    valid[-1] = False  # an image with no targets
    tb = tb * valid[..., None]
    return logits, boxes, tb, valid


def _cost(assign, cost):
    """Total cost of (..., T) assignments (-1 = unassigned) of (..., T, Q)."""
    idx = np.maximum(assign, 0)
    picked = np.take_along_axis(cost, idx[..., None], -1)[..., 0]
    return (picked * (assign >= 0)).sum(-1)


def test_matching_cost_matches_jax():
    logits, boxes, tb, _ = _problem(0)
    ref = jax.jit(jm.matching_cost)(jnp.asarray(logits), jnp.asarray(boxes),
                                    jnp.broadcast_to(jnp.asarray(tb), (2,) + tb.shape))
    out = pm.matching_cost(torch.from_numpy(logits), torch.from_numpy(boxes),
                           torch.from_numpy(tb).expand(2, *tb.shape))
    assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exact_match_equals_jax_jv(seed):
    logits, boxes, tb, valid = _problem(seed)
    tbl, vl = np.broadcast_to(tb, (2,) + tb.shape), np.broadcast_to(valid, (2,) + valid.shape)
    ref = _jv(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(tbl), jnp.asarray(vl))
    out = pm.hungarian_match(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (logits, boxes, tbl, vl)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy()[~vl] == -1).all()


def test_exact_cost_is_at_most_the_auction_cost():
    rng = np.random.RandomState(4)
    cost = rng.uniform(0, 10, (16, 8, 40)).astype(np.float32)
    valid = rng.uniform(size=(16, 8)) < 0.8
    exact = pm.solve_assignment(cost, valid)
    auction = np.asarray(jax.jit(jm.auction)(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(exact >= 0, valid)
    c_exact, c_auction = _cost(exact, cost), _cost(auction, cost)
    assert (c_exact <= c_auction + 1e-4).all(), (c_exact - c_auction).max()
    # every valid row takes a distinct query
    for a in exact:
        taken = a[a >= 0]
        assert len(set(taken.tolist())) == len(taken)


def test_one_to_many_matches_jax():
    logits, boxes, tb, valid = _problem(5, layers=1)
    ref_idx, ref_valid = jax.jit(jm.one_to_many_match)(
        jnp.asarray(logits[0]), jnp.asarray(boxes[0]), jnp.asarray(tb), jnp.asarray(valid))
    idx, ok = pm.one_to_many_match(torch.from_numpy(logits[0]), torch.from_numpy(boxes[0]),
                                   torch.from_numpy(tb), torch.from_numpy(valid), topk=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_valid))
