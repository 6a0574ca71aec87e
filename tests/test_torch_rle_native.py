"""The port's native RLE codec (``sam3_lora_tpu_torch/csrc/rle.cpp`` through
``ops/rle_native.py``): its source byte for byte the JAX package's
``native/rle.cpp``; its strings byte for byte the numpy encoder's (the
port's ``rle_encode_numpy`` and the JAX package's), and its decode bit for
bit the numpy decoder's, on empty, full, odd-sized and random masks (tolerance
0); each ctypes entry against its numpy counterpart; ``downsample_mask_exact``
against the JAX package's native one; the build lands in ``_build/`` keyed
on the source hash, and a build that cannot run raises."""

import os

import numpy as np
import pytest

from sam3_lora_tpu.ops import rle as jrle
from sam3_lora_tpu_torch.ops import rle, rle_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases():
    rng = np.random.RandomState(0)
    out = {
        "empty": np.zeros((7, 5), np.uint8),
        "full": np.ones((6, 9), np.uint8),
        "zero-size": np.zeros((0, 4), np.uint8),
        "odd-hw": (rng.rand(33, 17) > 0.5).astype(np.uint8),
        "one-pixel-on": np.pad(np.ones((1, 1), np.uint8), ((4, 2), (3, 5))),
        "first-pixel": np.pad(np.ones((1, 1), np.uint8), ((0, 4), (0, 6))),
        "random-288": (rng.rand(288, 288) > 0.5).astype(np.uint8),
        "sparse-1200x900": (rng.rand(1200, 900) > 0.999).astype(np.uint8),
        "bool": rng.rand(15, 21) > 0.7,
    }
    long = np.zeros((1000, 3), np.uint8)  # counts over 2**5 and 2**10, deltas both ways
    long[:700, 0] = 1
    long[10:990, 2] = 1
    out["long-runs"] = long
    return out


CASES = _cases()


def test_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "sam3_lora_tpu_torch", "csrc", "rle.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "sam3_lora_tpu", "native", "rle.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(CASES))
def test_codec_matches_numpy(name):
    m = CASES[name]
    got = rle.rle_encode(m)
    want = rle.rle_encode_numpy(m)
    assert got == want == jrle.rle_encode_numpy(m)
    assert isinstance(got["counts"], str)
    np.testing.assert_array_equal(rle.rle_decode(got), rle.rle_decode_numpy(want))
    np.testing.assert_array_equal(rle.rle_decode(got), np.asarray(m, np.uint8))
    counts = rle._mask_to_counts(m)
    np.testing.assert_array_equal(rle_native.rle_encode_counts(m), counts)
    np.testing.assert_array_equal(rle_native.rle_string_to_counts(got["counts"]),
                                  rle._string_to_counts(got["counts"]))
    # uncompressed counts decode the same way
    unc = {"size": list(m.shape), "counts": counts.tolist()}
    np.testing.assert_array_equal(rle.rle_decode(unc), rle.rle_decode_numpy(unc))


def test_bytes_counts_decode():
    m = CASES["odd-hw"]
    r = rle.rle_encode(m)
    np.testing.assert_array_equal(rle.rle_decode(dict(r, counts=r["counts"].encode())),
                                  np.asarray(m, np.uint8))


@pytest.mark.parametrize("shape,out", [((64, 64), 16), ((48, 96), 8), ((30, 30), 7)])
def test_downsample_mask_exact_matches_jax_native(shape, out):
    from sam3_lora_tpu import native

    m = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got = rle_native.downsample_mask_exact(m, out)
    want = native.downsample_mask_exact(m, out) if native.available() else None
    if shape[0] % out or shape[1] % out:
        assert got is None
        return
    fy, fx = shape[0] // out, shape[1] // out
    area = m.reshape(out, fy, out, fx).mean(axis=(1, 3))
    np.testing.assert_array_equal(got, (area > 0.5).astype(np.float32))
    assert want is not None, "the JAX package's native codec did not build"
    np.testing.assert_array_equal(got, want)


def test_build_is_keyed_and_cached():
    lib = rle_native.build()
    assert os.path.dirname(os.path.dirname(lib)) == rle_native.BUILD_DIR
    assert os.path.basename(lib) == "librle.so" and rle_native.build() == lib
    assert not os.path.exists(os.path.join(ROOT, "sam3_lora_tpu_torch", "csrc", "librle.so"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler (or a failing one): the codec raises, no path drops to numpy."""
    monkeypatch.setattr(rle_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(rle_native, "COMPILER", "no-such-compiler-g++")
    rle_native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no-such-compiler"):
            rle.rle_encode(CASES["odd-hw"])
        with pytest.raises(RuntimeError, match="no-such-compiler"):
            rle.rle_decode({"size": [2, 2], "counts": "11"})
        monkeypatch.setattr(rle_native, "COMPILER", "false")  # runs, exits 1
        with pytest.raises(RuntimeError, match="failed"):
            rle_native.build()
        assert not list(tmp_path.rglob("librle.so"))
    finally:
        rle_native.library.cache_clear()
