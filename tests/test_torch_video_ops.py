"""The video tier's device ops against the JAX package's, on the CPU with
the same seeded numpy inputs: the approximate auction
(``train/matcher.py::auction`` against ``_auction_single`` vmapped), the
association (``ops/association.py::associate_det_trk``), and the connected
components, component sizes and EDT (``ops/cc.py``). Every output is
discrete or exact, so each is held equal, bit for bit: assignments,
labels, sizes, incidences, and the IoU and scores (the same fp32 count
ratio and products on both sides).

Auction cases: random problems, near-ties (values on a 1/4 grid, so that
bids tie and the lowest row wins), invalid rows, more rows than columns
(a price war that never settles, stopped at the cap: the winner flips
with the parity of the iteration count, so 1023, 1024 and 1025 iterations
each give JAX's), and a batch of problems that converge at different
iterations. CC cases: the snake, random masks of several densities, a
batch equal to the masks one at a time and to JAX's. The error-region point
sampler (``ops/cc.py::sample_point_from_error_region``, whose JAX ``rng``
is unused): false negatives or false positives the larger region, equal
counts (the false negatives win), an EDT tie (the lowest linear index
wins) and no error ((0, 0), positive), each equal to JAX's."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import association as jassociation
from sam3_lora_tpu.ops import cc as jcc
from sam3_lora_tpu.train import matcher as jmatcher
from sam3_lora_tpu_torch.ops.association import associate_det_trk
from sam3_lora_tpu_torch.ops.cc import (
    component_sizes, connected_components, edt, sample_point_from_error_region,
)
from sam3_lora_tpu_torch.train import matcher


def jax_auction(cost, valid, max_iters=1024):
    fn = jax.vmap(partial(jmatcher._auction_single, max_iters=max_iters))
    return np.asarray(jax.jit(fn)(jnp.asarray(cost), jnp.asarray(valid)))


def _problems(seed, b, t, q, grid=None):
    rng = np.random.RandomState(seed)
    cost = rng.rand(b, t, q).astype(np.float32)
    if grid:
        cost = np.round(cost * grid) / grid
    return cost, rng.rand(b, t) > 0.25


@pytest.mark.parametrize("case", ["random", "near_ties", "square", "one_column"])
def test_auction_equals_jax(case):
    cost, valid = {
        "random": lambda: _problems(0, 6, 5, 9),
        "near_ties": lambda: _problems(1, 6, 6, 8, grid=4),
        "square": lambda: _problems(2, 4, 7, 7),
        "one_column": lambda: _problems(3, 3, 1, 1),
    }[case]()
    want = jax_auction(cost, valid)
    got = matcher.auction(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()
    # a valid row's column is unique within its problem
    for row, v in zip(got, valid):
        cols = row[v & (row >= 0)]
        assert len(set(cols.tolist())) == len(cols)


def test_auction_invalid_rows_and_default_validity():
    cost, _ = _problems(4, 2, 4, 6)
    valid = np.array([[True, False, True, False], [False, False, False, False]])
    np.testing.assert_array_equal(
        matcher.auction(torch.from_numpy(cost), torch.from_numpy(valid)).numpy(),
        jax_auction(cost, valid))
    np.testing.assert_array_equal(
        matcher.auction(torch.from_numpy(cost)).numpy(),
        np.asarray(jax.jit(jmatcher.auction)(jnp.asarray(cost))))


@pytest.mark.parametrize("cap", [1023, 1024, 1025])
def test_auction_stops_at_the_cap_as_jax(cap):
    """Three rows, two columns: the unassigned row always outbids, so the
    auction never converges and the cap decides who holds each column; the
    holders change with every iteration, so the result pins the count."""
    cost = np.array([[[0.1, 0.2], [0.3, 0.1], [0.2, 0.2]]], np.float32)
    valid = np.ones((1, 3), bool)
    want = jax_auction(cost, valid, max_iters=cap)
    got = matcher.auction(torch.from_numpy(cost), torch.from_numpy(valid), max_iters=cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # the holders at one cap differ from those one iteration later
    later = matcher.auction(torch.from_numpy(cost), torch.from_numpy(valid), max_iters=cap + 1)
    assert not np.array_equal(later.numpy(), want)


def test_auction_batch_converging_at_different_iterations():
    """Problems that settle after 1, a few and many iterations, batched:
    each equals its JAX result (a settled problem's iterations are
    no-ops)."""
    easy = np.eye(4, dtype=np.float32)[None] * -1.0 + 1.0          # one round
    tied = np.zeros((1, 4, 4), np.float32)                          # one column a round
    cost = np.concatenate([easy, tied, _problems(5, 1, 4, 4, grid=2)[0]])
    valid = np.ones((3, 4), bool)
    want = jax_auction(cost, valid)
    np.testing.assert_array_equal(
        matcher.auction(torch.from_numpy(cost), torch.from_numpy(valid)).numpy(), want)
    for i in range(3):
        np.testing.assert_array_equal(
            matcher.auction(torch.from_numpy(cost[i]), torch.from_numpy(valid[i])).numpy(),
            want[i])


def _blob(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _assoc_inputs(seed):
    rng = np.random.RandomState(seed)
    det = np.stack([_blob(24, 24, *rng.randint(4, 20, 2), rng.randint(3, 7)) for _ in range(7)])
    trk = np.stack([_blob(24, 24, *rng.randint(4, 20, 2), rng.randint(3, 7)) for _ in range(5)])
    trk[:2] = det[:2] ^ (rng.rand(2, 24, 24) > 0.97)   # near-copies: matches
    return (det.astype(np.float32) * 2 - 1, trk.astype(np.float32) * 2 - 1,
            rng.rand(7) > 0.2, rng.rand(5) > 0.2, rng.rand(7).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("validity", [True, False])
def test_association_equals_jax(seed, validity):
    det, trk, dv, tv, ds = _assoc_inputs(seed)
    kw = dict(iou_threshold=0.4, iou_threshold_trk=0.3, new_det_thresh=0.3)
    if validity:
        args, targs = (dv, tv, ds), tuple(torch.from_numpy(a) for a in (dv, tv, ds))
    else:
        args, targs = (None, None, ds), (None, None, torch.from_numpy(ds))
    jfn = jax.jit(partial(jassociation.associate_det_trk, **kw))
    want = jfn(jnp.asarray(det), jnp.asarray(trk),
               *[None if a is None else jnp.asarray(a) for a in args])
    got = associate_det_trk(torch.from_numpy(det), torch.from_numpy(trk), *targs, **kw)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_association_matching_rules():
    h = w = 32
    d0, d1 = _blob(h, w, 8, 8, 5), _blob(h, w, 24, 24, 5)
    t0, t1 = _blob(h, w, 8, 9, 5), _blob(h, w, 8, 28, 4)
    out = associate_det_trk(torch.from_numpy(np.stack([d0, d1]).astype(np.float32)),
                            torch.from_numpy(np.stack([t0, t1]).astype(np.float32)),
                            det_scores=torch.tensor([0.9, 0.8]))
    assert out.new_det.tolist() == [False, True]
    assert out.unmatched_trk.tolist() == [False, True]
    assert bool(out.det_to_trk[0, 0]) and float(out.matched_det_score[0]) == pytest.approx(0.9)


def _snake(n=40):
    mask = np.zeros((n, n), bool)
    for i in range(0, n, 2):
        mask[i, :] = True
        if i + 1 < n:
            mask[i + 1, -1 if (i // 2) % 2 == 0 else 0] = True
    return mask


def _jax_labels(masks):
    fn = jax.jit(jcc.connected_components)
    return np.stack([np.asarray(fn(jnp.asarray(m))) for m in masks])


def test_cc_snake_is_one_component_as_jax():
    mask = _snake()
    got = connected_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _jax_labels(mask[None])[0])
    assert len(set(got[mask].tolist())) == 1 and (got[~mask] == -1).all()


@pytest.mark.parametrize("density", [0.3, 0.45, 0.6])
def test_cc_random_batch_equals_jax_and_per_mask(density):
    masks = np.random.RandomState(int(density * 100)).rand(4, 30, 26) > density
    want = _jax_labels(masks)
    got = connected_components(torch.from_numpy(masks)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for m, g in zip(masks, got):
        np.testing.assert_array_equal(connected_components(torch.from_numpy(m)).numpy(), g)
    # the partition is scipy's 8-connected one
    from scipy import ndimage

    for m, g in zip(masks, got):
        ref, n = ndimage.label(m, structure=np.ones((3, 3)))
        assert len(set(zip(g[m].tolist(), ref[m].tolist()))) == n


def test_cc_few_sweeps_stop_where_jax_stops():
    """With max_iters 1 a long snake is not yet one label: the labels at
    the cap are JAX's, not a fixpoint."""
    mask = _snake(64)
    got = connected_components(torch.from_numpy(mask), max_iters=1).numpy()
    want = np.asarray(jax.jit(partial(jcc.connected_components, max_iters=1))(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert len(set(got[mask].tolist())) > 1


def test_component_sizes_equal_jax():
    masks = np.random.RandomState(7).rand(3, 20, 20) > 0.5
    labels = _jax_labels(masks)
    got = component_sizes(torch.from_numpy(labels)).numpy()
    want = np.stack([np.asarray(jcc.component_sizes(jnp.asarray(x))) for x in labels])
    np.testing.assert_array_equal(got, want)
    assert got.sum(axis=1).tolist() == masks.reshape(3, -1).sum(axis=1).tolist()


@pytest.mark.parametrize("chunk", [7, 256])
def test_edt_equals_jax(chunk):
    mask = np.random.RandomState(1).rand(24, 19) > 0.3
    want = np.asarray(jax.jit(partial(jcc.edt, chunk=chunk))(jnp.asarray(mask)))
    got = edt(torch.from_numpy(mask), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)
    ys, xs = np.where(~mask)
    i, j = 5, 7
    assert got[i, j] == (0 if not mask[i, j] else ((ys - i) ** 2 + (xs - j) ** 2).min())


def _error_case(case):
    """-> (pred, gt) (H, W) masks of one point-sampler case."""
    rng = np.random.RandomState(3)
    h, w = 23, 29
    pred, gt = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
    if case == "fn_dominates":
        gt[2:15, 4:20] = 1
        pred[5:9, 6:12] = 1
        pred[18:20, 22:25] = 1          # a small false positive
    elif case == "fp_dominates":
        pred = (rng.rand(h, w) > 0.4).astype(np.float32) * rng.uniform(0.1, 3.0, (h, w))
        gt[10:13, 10:13] = 1
    elif case == "equal_counts":
        gt[1:5, 1:5] = 1                # 16 missed pixels
        pred[10:14, 20:24] = 1          # 16 spurious ones
    elif case == "edt_tie":
        gt[4:8, 4:8] = 1                # a 4x4 region: its inner 2x2 tie
        gt[14:18, 20:24] = 1            # a second, equally deep
    elif case == "random":
        gt = (rng.rand(h, w) > 0.5).astype(np.float32)
        pred = rng.standard_normal((h, w)).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("case", ["fn_dominates", "fp_dominates", "equal_counts", "edt_tie",
                                  "no_error", "random"])
def test_error_point_equals_jax(case):
    pred, gt = _error_case(case)
    if case == "no_error":
        pred = gt = (np.random.RandomState(4).rand(23, 29) > 0.5).astype(np.float32)
    want_yx, want_pos = jax.jit(jcc.sample_point_from_error_region)(
        jnp.asarray(pred), jnp.asarray(gt), jax.random.PRNGKey(0))
    yx, pos = sample_point_from_error_region(torch.from_numpy(pred), torch.from_numpy(gt))
    assert yx.dtype == torch.int32 and pos.dtype == torch.bool
    np.testing.assert_array_equal(yx.numpy(), np.asarray(want_yx))
    assert bool(pos) == bool(want_pos)
    y, x = yx.tolist()
    if case == "no_error":
        assert (y, x, bool(pos)) == (0, 0, True)
    elif case == "equal_counts":
        assert bool(pos) and gt[y, x] == 1
    elif case == "fp_dominates":
        assert not bool(pos) and pred[y, x] > 0 and gt[y, x] == 0
    elif case == "edt_tie":
        assert (y, x) == (5, 5)         # the first of the tied maxima
