"""K1 plain version of the PyTorch port against the JAX Pallas window
kernels run in interpret mode, at L not a multiple of 64. fp32, tolerance
2e-5 as in the JAX kernel tests. The JAX default softmax is the clamp form,
which equals the port's exact softmax while the row max stays below 70
(these inputs keep |s| < 10); the exact-max JAX mode is checked as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import window_attention as wa
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import (
    window_attention_rope_packed,
    window_attention_rope_packed_plain,
)

from torch_port_helpers import assert_close

TOL = 2e-5


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)


def _inputs(n, l, p, dh, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((n, l, p * dh)).astype(np.float32) for _ in range(3))
    ang = compute_axial_freqs(dh, 5, 8).astype(np.float32)  # (40, dh/2) for L = 40
    return q, k, v, np.cos(ang[:l]), np.sin(ang[:l])


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("dh", [32, 64])
def test_rope_packed_matches_jax_kernel(interpret_kernels, monkeypatch, clamp, dh):
    monkeypatch.setattr(wa, "_CLAMP_MAX", clamp)
    q, k, v, cos, sin = _inputs(3, 40, 2, dh)
    scale = dh ** -0.5
    assert np.abs(np.einsum("nld,nmd->nlm", q[..., :dh], k[..., :dh])).max() * scale < 70
    ref = wa.window_attention_rope_packed(
        *(jnp.asarray(t) for t in (q, k, v)), scale, jnp.asarray(cos), jnp.asarray(sin)
    )
    T = torch.from_numpy
    out = window_attention_rope_packed(T(q), T(k), T(v), scale, T(cos), T(sin))
    assert_close(out, ref, rtol=TOL, atol=TOL)
    assert_close(window_attention_rope_packed_plain(T(q), T(k), T(v), scale, T(cos), T(sin)),
                 out, rtol=0, atol=0)


def test_plain_without_rope_matches_jax_packed_kernel(interpret_kernels):
    # window_attention_packed is the rope-less K1 variant: the port's plain
    # core with identity tables must give the same numbers
    q, k, v, _, _ = _inputs(2, 40, 2, 32, seed=1)
    ref = wa.window_attention_packed(*(jnp.asarray(t) for t in (q, k, v)), 32 ** -0.5)
    ones, zeros = torch.ones(40, 16), torch.zeros(40, 16)
    T = torch.from_numpy
    out = window_attention_rope_packed(T(q), T(k), T(v), 32 ** -0.5, ones, zeros)
    assert_close(out, ref, rtol=TOL, atol=TOL)


def test_strided_views_match_contiguous():
    # the ViT passes q/k/v as views of its (N, L, 3*D) qkv projection output
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3 * 64)).astype(np.float32))
    _, _, _, cos, sin = _inputs(1, 40, 1, 32)
    cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    out = window_attention_rope_packed(q, k, v, 0.2, cos, sin)
    ref = window_attention_rope_packed(q.contiguous(), k.contiguous(), v.contiguous(), 0.2, cos, sin)
    assert_close(out, ref, rtol=0, atol=0)


def test_launch_counter_counts_only_kernel_launches():
    q, k, v, cos, sin = (torch.from_numpy(t) for t in _inputs(1, 40, 2, 32))
    before = window_attention_rope_packed.launches
    window_attention_rope_packed(q, k, v, 0.2, cos, sin)  # CPU: the plain version
    assert window_attention_rope_packed.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        window_attention_rope_packed(q.to("meta"), k.to("meta"), v.to("meta"), 0.2, cos, sin)
