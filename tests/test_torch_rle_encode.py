"""The port's RLE encoder (``sam3_lora_tpu_torch/ops/rle.py``) against the
JAX package's: ``rle_encode`` byte for byte equal to JAX ``rle_encode_numpy``
(and to the JAX package's C++ codec where it builds), empty and full masks
and odd sizes included; ``rle_area`` and the decode round trip exact;
``rle_counts_device`` equal to JAX's element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import rle as jrle
from sam3_lora_tpu_torch.ops import rle


def _cases():
    rng = np.random.RandomState(0)
    out = {
        "empty": np.zeros((7, 5), np.uint8),
        "full": np.ones((6, 9), np.uint8),
        "first-pixel": np.pad(np.ones((1, 1), np.uint8), ((0, 4), (0, 6))),
        "last-pixel": np.pad(np.ones((1, 1), np.uint8), ((4, 0), (6, 0))),
        "one-row": (rng.rand(1, 37) > 0.5).astype(np.uint8),
        "one-col": (rng.rand(29, 1) > 0.5).astype(np.uint8),
        "noise-odd": (rng.rand(33, 17) > 0.5).astype(np.uint8),
        "noise-288": (rng.rand(288, 288) > 0.5).astype(np.uint8),
        "bool": rng.rand(15, 21) > 0.7,
    }
    blob = np.zeros((101, 77), np.uint8)
    blob[13:90, 5:60] = 1
    blob[40:50, 20:30] = 0
    out["blob-with-hole"] = blob
    # long runs: counts over 2**5 and 2**10, large deltas both ways
    long = np.zeros((1000, 3), np.uint8)
    long[:700, 0] = 1
    long[10:990, 2] = 1
    out["long-runs"] = long
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_rle_encode_matches_jax_byte_for_byte(name):
    m = CASES[name]
    got = rle.rle_encode(m)
    assert got == jrle.rle_encode_numpy(m)
    assert isinstance(got["counts"], str) and got["size"] == list(m.shape)
    nat = jrle._native()
    if nat is not None:
        assert got == nat.rle_encode(np.asarray(m, np.uint8))
    # round trip through the port's decoder, and its area
    np.testing.assert_array_equal(rle.rle_decode(got), np.asarray(m, np.uint8))
    assert rle.rle_area(got) == int(np.asarray(m).sum()) == jrle.rle_area(got)


def test_rle_area_of_uncompressed_counts():
    counts = {"size": [4, 5], "counts": [3, 4, 2, 6, 5]}
    assert rle.rle_area(counts) == jrle.rle_area(counts) == 10


@pytest.mark.parametrize("name", ["empty", "full", "noise-odd", "blob-with-hole"])
def test_rle_counts_device_matches_jax(name):
    m = np.asarray(CASES[name], np.uint8)
    jflat, jchange = jrle.rle_counts_device(jnp.asarray(m))
    flat, change = rle.rle_counts_device(torch.from_numpy(m))
    assert flat.dtype == torch.uint8 and change.dtype == torch.bool
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(change.numpy(), np.asarray(jchange))
    # the run boundaries give the encoder's counts
    starts = np.nonzero(change.numpy())[0]
    runs = np.diff(np.concatenate([starts, [m.size]]))
    counts = np.concatenate([[0], runs]) if flat[0] == 1 else runs
    np.testing.assert_array_equal(counts, rle._mask_to_counts(m))
