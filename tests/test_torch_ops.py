"""Plain ops of the PyTorch port against the JAX package on the same numpy
inputs, in fp32. Tolerances: exact index/table ops compare at 0 or 1e-6;
arithmetic ops at 1e-5 (fp32, differing only in evaluation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import boxes as jboxes
from sam3_lora_tpu.ops import interpolate as jinterp
from sam3_lora_tpu.ops import posenc as jposenc
from sam3_lora_tpu.ops import rope as jrope
from sam3_lora_tpu.ops import sampling as jsampling
from sam3_lora_tpu.ops import windows as jwindows
from sam3_lora_tpu.ops.attention import dot_product_attention as jattn
from sam3_lora_tpu.ops.rpb_attention import separable_bias_attention as jrpb
from sam3_lora_tpu_torch.ops import boxes, interpolate, posenc, rope, sampling, windows
from sam3_lora_tpu_torch.ops.attention import dot_product_attention
from sam3_lora_tpu_torch.ops.rpb_attention import separable_bias_attention

from torch_port_helpers import assert_close

T = torch.from_numpy


def test_rope_tables_and_rotation():
    rng = np.random.RandomState(0)
    for scale_pos in (1.0, 1.0 / 3.0):
        np.testing.assert_array_equal(
            rope.compute_axial_freqs(16, 6, 6, scale_pos=scale_pos),
            jrope.compute_axial_freqs(16, 6, 6, scale_pos=scale_pos),
        )
    np.testing.assert_array_equal(rope.rope_half_perm(16), jrope.rope_half_perm(16))
    ang = rope.compute_axial_freqs(16, 6, 6).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    x = rng.standard_normal((2, 3, 36, 16)).astype(np.float32)
    assert_close(
        rope.apply_rope_half(T(x), T(cos), T(sin)),
        jrope.apply_rope_half(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("hw", [(8, 8), (7, 10)])
def test_window_partition_roundtrip(hw):
    x = np.random.RandomState(1).standard_normal((2, *hw, 5)).astype(np.float32)
    win, pad = windows.window_partition(T(x), 4)
    jwin, jpad = jwindows.window_partition(jnp.asarray(x), 4)
    assert pad == jpad
    assert_close(win, jwin, rtol=0, atol=0)
    back = windows.window_unpartition(win, 4, pad, hw)
    assert_close(back, x, rtol=0, atol=0)


def test_sine_pos_grid():
    assert_close(posenc.sine_pos_grid(5, 7, 32),
                 jax.jit(jposenc.sine_pos_grid, static_argnums=(0, 1, 2))(5, 7, 32),
                 rtol=1e-5, atol=1e-5)


def test_box_and_point_encodings():
    b = np.random.RandomState(2).rand(3, 4, 4).astype(np.float32)
    assert_close(
        posenc.encode_boxes(*T(b).unbind(-1), num_pos_feats=32),
        jposenc.encode_boxes(*[jnp.asarray(b[..., i]) for i in range(4)], num_pos_feats=32),
        rtol=1e-5, atol=1e-5,
    )
    assert_close(posenc.gen_sineembed_for_position(T(b), 32),
                 jposenc.gen_sineembed_for_position(jnp.asarray(b), 32), rtol=1e-5, atol=1e-5)
    ex, ey = posenc.encode_xy(T(b[..., 0]), T(b[..., 1]), 32)
    jex, jey = jposenc.encode_xy(jnp.asarray(b[..., 0]), jnp.asarray(b[..., 1]), 32)
    assert_close(ex, jex, rtol=1e-5, atol=1e-5)
    assert_close(ey, jey, rtol=1e-5, atol=1e-5)


def test_boxes():
    b = np.random.RandomState(3).rand(5, 4).astype(np.float32)
    assert_close(boxes.box_cxcywh_to_xyxy(T(b)), jboxes.box_cxcywh_to_xyxy(jnp.asarray(b)),
                 rtol=0, atol=1e-7)
    x = np.array([0.0, 1e-4, 0.3, 0.999, 1.0], np.float32)
    assert_close(boxes.inverse_sigmoid(T(x)), jboxes.inverse_sigmoid(jnp.asarray(x)),
                 rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(12, 18), (4, 5)])
def test_resize_bilinear(size):
    x = np.random.RandomState(4).standard_normal((2, 3, 6, 9)).astype(np.float32)
    assert_close(interpolate.resize_bilinear(T(x), size),
                 jinterp.resize_bilinear(jnp.asarray(x), size), rtol=1e-5, atol=1e-5)


def test_resize_nearest():
    x = np.random.RandomState(4).standard_normal((2, 3, 6, 9)).astype(np.float32)
    for size in ((12, 18), (5, 7)):
        assert_close(interpolate.resize_nearest(T(x), size),
                     jinterp.resize_nearest(jnp.asarray(x), size), rtol=0, atol=0)


def test_roi_align():
    img = np.random.RandomState(5).standard_normal((2, 3, 9, 11)).astype(np.float32)
    xyxy = np.array(
        [
            [[1.0, 1.5, 6.2, 7.0], [-2.0, -1.0, 3.0, 2.0], [0.2, 0.3, 0.6, 0.9]],
            [[4.0, 2.0, 30.0, 8.5], [8.0, 7.0, 12.5, 10.0], [0.0, 0.0, 11.0, 9.0]],
        ],
        np.float32,
    )
    ref = jax.jit(jsampling.roi_align, static_argnames="output_size")(
        jnp.asarray(img), jnp.asarray(xyxy), output_size=3
    )
    assert_close(sampling.roi_align(T(img), T(xyxy), output_size=3), ref, rtol=1e-5, atol=1e-5)


def test_grid_sample():
    rng = np.random.RandomState(5)
    img = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 5, 2)).astype(np.float32)
    assert_close(sampling.grid_sample(T(img), T(grid)),
                 jsampling.grid_sample(jnp.asarray(img), jnp.asarray(grid)), rtol=1e-5, atol=1e-5)


def test_dot_product_attention_bias_and_padding():
    rng = np.random.RandomState(6)
    q, k, v = (rng.standard_normal((2, 3, n, 8)).astype(np.float32) for n in (5, 7, 7))
    bias = rng.standard_normal((1, 3, 5, 7)).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[0, 4:] = True
    kpm[1, :] = True  # fully padded row: uniform softmax, not NaN
    out = dot_product_attention(T(q), T(k), T(v), bias=T(bias), key_padding_mask=T(kpm))
    ref = jattn(*(jnp.asarray(t) for t in (q, k, v)), bias=jnp.asarray(bias),
                key_padding_mask=jnp.asarray(kpm))
    assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(out).all()


def test_separable_bias_attention():
    rng = np.random.RandomState(7)
    gh, gw = 4, 6
    q = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, gh * gw, 8)).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((2, 5, gh, 3)).astype(np.float32)
    dx = rng.standard_normal((2, 5, gw, 3)).astype(np.float32)
    ref = jax.jit(jrpb, static_argnames="grid_hw")(
        *(jnp.asarray(t) for t in (q, k, v, dy, dx)), grid_hw=(gh, gw)
    )
    for rows in (1, 2, 4):
        out = separable_bias_attention(T(q), T(k), T(v), T(dy), T(dx), grid_hw=(gh, gw), rows=rows)
        assert_close(out, ref, rtol=1e-5, atol=1e-5, name=f"rows={rows}")
