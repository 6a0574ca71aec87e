"""Backward of the three attention entry points (K1-bwd, K2/3-bwd) on the
CPU, where the port's autograd Function runs the plain backward
``attention_packed_bwd_plain``:

* against ``jax.grad`` through the JAX Pallas entry points in interpret mode,
  at L not a multiple of 64. fp32; tolerance 1e-4 relative to the largest
  gradient: the JAX kernels accumulate dK/dV across query tiles and recompute
  P blockwise, so sums run in another order than the plain version's. The
  JAX default softmax is the clamp form, equal to the port's exact softmax
  while |s| < 70, which these inputs keep; the exact JAX mode is checked too;
* ``attention_packed_bwd_plain`` against ``torch.autograd`` of
  ``attention_packed_plain`` (fp32, 1e-5 relative), at ragged L;
* the packed-qkv Function (one gradient tensor for the ViT's qkv output)
  against the three-operand Function (bitwise: the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import long_attention as la
from sam3_lora_tpu.ops import window_attention as wa
from sam3_lora_tpu_torch.ops.attention_kernel import (
    attend_qkv,
    attention_packed_bwd_plain,
    attention_packed_plain,
)
from sam3_lora_tpu_torch.ops.long_attention import long_attention_packed, long_attention_rope_packed
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import window_attention_rope_packed

RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def jax_backend():
    jnp.zeros(8).block_until_ready()  # the backend starts in the module's setup


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(la, "_FORCE_INTERPRET", True)


def _inputs(n, l, p, dh, seed, side=None):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.standard_normal((n, l, p * dh)).astype(np.float32) for _ in range(4))
    side = side or (l, 1)
    ang = compute_axial_freqs(dh, side[0], side[1], scale_pos=1.0 / 3.0).astype(np.float32)[:l]
    return q, k, v, do, np.cos(ang), np.sin(ang)


def _assert_grads(port, ref, rtol=RTOL):
    for name, a, b in zip(("dq", "dk", "dv"), port, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b).max()
        assert err <= rtol * np.abs(b).max(), f"{name}: max err {err:.3e} vs max |ref| {np.abs(b).max():.3e}"


def _port_grads(entry_call, q, k, v, do):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = entry_call(*ts)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, do):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("dh", [32, 64])
def test_window_bwd_matches_jax_kernel(interpret_kernels, monkeypatch, clamp, dh):
    p = 2
    monkeypatch.setattr(wa, "_CLAMP_MAX", clamp)
    q, k, v, do, cos, sin = _inputs(2, 40, p, dh, seed=p, side=(5, 8))
    scale = dh ** -0.5
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    ref = _jax_grads(lambda q, k, v: wa.window_attention_rope_packed(q, k, v, scale, jc, js),
                     q, k, v, do)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    port = _port_grads(lambda q, k, v: window_attention_rope_packed(q, k, v, scale, tc, ts),
                       q, k, v, do)
    _assert_grads(port, ref)


@pytest.mark.parametrize("mode", ["clamp", "max"])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32)])
def test_long_bwd_matches_jax_kernel(interpret_kernels, monkeypatch, mode, rope, p, dh):
    monkeypatch.setattr(la, "_SOFTMAX_MODE", mode)
    q, k, v, do, cos, sin = _inputs(2, 72, p, dh, seed=10 + p, side=(9, 8))
    scale = dh ** -0.5
    if rope:
        jc, js = jnp.asarray(cos), jnp.asarray(sin)
        tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
        ref = _jax_grads(
            lambda q, k, v: la.long_attention_rope_packed(q, k, v, scale, dh, jc, js), q, k, v, do)
        port = _port_grads(
            lambda q, k, v: long_attention_rope_packed(q, k, v, scale, dh, tc, ts), q, k, v, do)
    else:
        ref = _jax_grads(lambda q, k, v: la.long_attention_packed(q, k, v, scale, dh), q, k, v, do)
        port = _port_grads(lambda q, k, v: long_attention_packed(q, k, v, scale, dh), q, k, v, do)
    _assert_grads(port, ref)


@pytest.mark.parametrize("l", [1, 37, 77])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32)])
def test_plain_bwd_matches_autograd_of_plain_fwd(l, rope, p, dh):
    q, k, v, do, cos, sin = (torch.from_numpy(t) for t in _inputs(2, l, p, dh, seed=l))
    cos, sin = (cos, sin) if rope else (None, None)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention_packed_plain(*ts, 0.3, dh, cos, sin)
    out.backward(do)
    ref = [t.grad.numpy() for t in ts]
    port = attention_packed_bwd_plain(q, k, v, out.detach(), do, 0.3, dh, cos, sin)
    if l == 1:
        # one key: P = 1, so dS = 0, and dq, dk are rounding noise on both
        # sides; they are held to 1e-5 of the gradient's scale (max |dv|)
        scale = np.abs(ref[2]).max()
        assert all(np.abs(g.numpy()).max() <= 1e-5 * scale for g in port[:2])
        assert all(np.abs(g).max() <= 1e-5 * scale for g in ref[:2])
        _assert_grads(port[2:], ref[2:], rtol=1e-5)
    else:
        _assert_grads([g.numpy() for g in port], ref, rtol=1e-5)


def test_packed_qkv_function_matches_three_operand_function():
    q, k, v, do, cos, sin = (torch.from_numpy(t) for t in _inputs(3, 40, 2, 32, seed=5))
    qkv = torch.cat([q, k, v], dim=-1).requires_grad_(True)
    out = attend_qkv(window_attention_rope_packed, qkv, 0.25, 32, cos, sin)
    out.backward(do)
    port = _port_grads(lambda q, k, v: window_attention_rope_packed(q, k, v, 0.25, cos, sin),
                       *(t.numpy() for t in (q, k, v)), do.numpy())
    np.testing.assert_array_equal(qkv.grad.numpy(), np.concatenate(port, axis=-1))


def test_no_grad_path_counts_and_builds_no_graph():
    q, k, v, _, cos, sin = (torch.from_numpy(t) for t in _inputs(1, 40, 2, 32, seed=6))
    fwd, bwd = window_attention_rope_packed.launches, window_attention_rope_packed.bwd_launches
    out = window_attention_rope_packed(q, k, v, 0.2, cos, sin)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    window_attention_rope_packed(qg, k, v, 0.2, cos, sin).sum().backward()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (window_attention_rope_packed.launches, window_attention_rope_packed.bwd_launches) == (fwd, bwd)
    assert torch.isfinite(qg.grad).all() and qg.grad.abs().max() > 0
