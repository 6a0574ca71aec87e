"""K2/K3 plain versions of the PyTorch port against the JAX Pallas long
kernels run in interpret mode, at P = 2 / dh = 64 and P = 4 / dh = 32, with
L a multiple of 8 but not of 128 (the JAX kernel pads and zeroes the pad
columns; the port masks in the kernel). fp32, tolerance 2e-5. The JAX
"clamp" default equals the exact softmax for these inputs (|s| < 70)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import long_attention as la
from sam3_lora_tpu_torch.ops.long_attention import (
    long_attention_packed,
    long_attention_packed_plain,
    long_attention_rope_packed,
    long_attention_rope_packed_plain,
)
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs

from torch_port_helpers import assert_close

TOL = 2e-5
L = 72


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(la, "_FORCE_INTERPRET", True)


def _inputs(p, dh, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((2, L, p * dh)).astype(np.float32) for _ in range(3))
    ang = compute_axial_freqs(dh, 9, 8, scale_pos=1.0 / 3.0).astype(np.float32)
    return q, k, v, np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("mode", ["clamp", "max"])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32)])
def test_long_packed_matches_jax_kernel(interpret_kernels, monkeypatch, mode, p, dh):
    monkeypatch.setattr(la, "_SOFTMAX_MODE", mode)
    q, k, v, _, _ = _inputs(p, dh, seed=p)
    scale = dh ** -0.5
    ref = la.long_attention_packed(*(jnp.asarray(t) for t in (q, k, v)), scale, dh)
    T = torch.from_numpy
    out = long_attention_packed(T(q), T(k), T(v), scale, dh)
    assert_close(out, ref, rtol=TOL, atol=TOL)
    assert_close(long_attention_packed_plain(T(q), T(k), T(v), scale, dh), out, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["clamp", "max"])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32)])
def test_long_rope_packed_matches_jax_kernel(interpret_kernels, monkeypatch, mode, p, dh):
    monkeypatch.setattr(la, "_SOFTMAX_MODE", mode)
    q, k, v, cos, sin = _inputs(p, dh, seed=10 + p)
    scale = dh ** -0.5
    ref = la.long_attention_rope_packed(
        *(jnp.asarray(t) for t in (q, k, v)), scale, dh, jnp.asarray(cos), jnp.asarray(sin)
    )
    T = torch.from_numpy
    out = long_attention_rope_packed(T(q), T(k), T(v), scale, dh, T(cos), T(sin))
    assert_close(out, ref, rtol=TOL, atol=TOL)
    assert_close(long_attention_rope_packed_plain(T(q), T(k), T(v), scale, dh, T(cos), T(sin)),
                 out, rtol=0, atol=0)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, cos, sin = (torch.from_numpy(t) for t in _inputs(4, 32, seed=0))
    before = (long_attention_packed.launches, long_attention_rope_packed.launches)
    long_attention_packed(q, k, v, 0.2, 32)
    long_attention_rope_packed(q, k, v, 0.2, 32, cos, sin)
    assert (long_attention_packed.launches, long_attention_rope_packed.launches) == before
