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
  against the three-operand Function (bitwise: the same formulas);
* the card's prep pass in its plain version (``attention_bwd_prep_plain``):
  q and k rotated, bit for bit the port's ``apply_rope_half`` in bf16 and
  within one bf16 ulp of the JAX one (XLA may fuse a multiply-add), and D
  within 1e-6 (relative) of the fp32 rowsum (the kernel's summation order);
* the TMA maps of the main kernels (``tma_map``): every operand layout
  chip_smoke.py hands the backward is admitted with the extents, byte
  strides and slots it has, and views TMA cannot read raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import long_attention as la
from sam3_lora_tpu.ops import rope as jax_rope
from sam3_lora_tpu.ops import window_attention as wa
from sam3_lora_tpu_torch.ops import attention_kernel as ak
from sam3_lora_tpu_torch.ops import rope as port_rope
from sam3_lora_tpu_torch.ops.attention_kernel import (
    attend_qkv,
    attention_bwd_prep_plain,
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


def _bf16_heads(rng, n, p, l, dh):
    x = rng.standard_normal((n, p, l, dh)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("dh", [32, 64])
def test_prep_rotation_equals_apply_rope_half(dh):
    rng = np.random.RandomState(dh)
    q, k, o, do = (_bf16_heads(rng, 2, 3, 37, dh) for _ in range(4))
    ang = compute_axial_freqs(dh, 37, 1, scale_pos=1.0 / 3.0).astype(np.float32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    q_rot, k_rot, _ = attention_bwd_prep_plain(q, k, o, do, cos, sin)
    assert q_rot.dtype == k_rot.dtype == torch.bfloat16
    assert torch.equal(q_rot, port_rope.apply_rope_half(q, cos, sin))
    assert torch.equal(k_rot, port_rope.apply_rope_half(k, cos, sin))
    # the JAX reference on the same bf16 values: within one bf16 ulp
    for got, x in ((q_rot, q), (k_rot, k)):
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        ref = np.asarray(jax_rope.apply_rope_half(xj, jnp.asarray(cos.numpy()),
                                                  jnp.asarray(sin.numpy())), np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got.float().numpy() - ref) <= ulp).all()
    # without tables q and k pass through
    q2, k2, _ = attention_bwd_prep_plain(q, k, o, do)
    assert q2 is q and k2 is k


@pytest.mark.parametrize("dh", [32, 64])
def test_prep_rowsum_matches_fp32(dh):
    rng = np.random.RandomState(7 + dh)
    q, k, o, do = (_bf16_heads(rng, 2, 4, 41, dh) for _ in range(4))
    _, _, d = attention_bwd_prep_plain(q, k, o, do)
    ref = (do.double() * o.double()).sum(-1)
    assert d.dtype == torch.float32 and d.shape == (2, 4, 41)
    assert (d.double() - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def _layouts():
    """(name, (N, P, L, dh) view) of every operand layout chip_smoke.py hands
    the backward, at L = 37: the packed qkv column blocks (K1, K2), the
    encoder's (N, L, 256) at dh 32 (K3), K1''s head pairs, the W-g strided
    views of the qkv output, W-p's pair views of them, a head-major
    contiguous tensor (the rotated scratch) and W-qkv's column blocks."""
    n, l, heads, dh = 2, 37, 4, 64
    qkv = torch.zeros(n, l, 3 * heads * dh, dtype=torch.bfloat16)
    cols = qkv.chunk(3, -1)
    views = [("packed_q", ak._heads(cols[0], dh)), ("packed_v", ak._heads(cols[2], dh)),
             ("encoder", ak._heads(torch.zeros(n, l, 256, dtype=torch.bfloat16), 32))]
    pairs = cols[1].reshape(n, l, heads // 2, 2 * dh).transpose(1, 2).reshape(-1, l, 2 * dh)
    views.append(("k1_pairs", ak._heads(pairs.contiguous(), dh)))
    grouped = qkv.reshape(n, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    views += [("w_g", grouped[0]), ("w_p", grouped[1].reshape(n * heads // 2, 2, l, dh)),
              ("contiguous", torch.zeros(n, heads, l, dh, dtype=torch.bfloat16)),
              ("w_qkv", ak._heads(qkv[..., heads * dh:2 * heads * dh], dh))]
    return views


@pytest.mark.parametrize("name,view", _layouts(), ids=[n for n, _ in _layouts()])
def test_tma_map_admits_every_main_path_layout(name, view):
    ak._check_layout(name, view, view.shape)
    spec = ak.tma_map(name, view)
    extents, strides, slots = spec[:3], spec[3:6], spec[6]
    assert len(spec) == 8 and spec[7] == 0 and strides == sorted(strides)
    where = {"l": slots & 15, "p": (slots >> 4) & 15, "n": (slots >> 8) & 15}
    assert sorted(where.values()) == [1, 2, 3]
    n, p, l, dh = view.shape
    for dim, size, stride in (("n", n, view.stride(0)), ("p", p, view.stride(1)),
                              ("l", l, view.stride(2))):
        assert extents[where[dim] - 1] == size
        if size > 1:
            assert strides[where[dim] - 1] == 2 * stride
    assert all(s % 16 == 0 and s > 0 for s in strides)
    assert len(ak.bwd_maps(view, view, view, view)) == 32


def test_tma_map_orders_dims_by_stride():
    qkv = torch.zeros(2, 37, 3 * 128, dtype=torch.bfloat16)
    packed = ak._heads(qkv[..., :128], 64)  # strides (n, p, l) = (14208, 64, 384)
    assert ak.tma_map("q", packed) == [2, 37, 2, 128, 768, 28416, 2 | 1 << 4 | 3 << 8, 0]
    head_major = torch.zeros(2, 3, 37, 32, dtype=torch.bfloat16)  # (3552, 1184, 32)
    assert ak.tma_map("q", head_major) == [37, 3, 2, 64, 2368, 7104, 1 | 2 << 4 | 3 << 8, 0]
    one_seq = torch.zeros(1, 2, 37, 64, dtype=torch.bfloat16)  # N = 1 goes last
    assert ak.tma_map("q", one_seq)[6] == 1 | 2 << 4 | 3 << 8


def test_tma_map_refuses_views_tma_cannot_read():
    qkv = torch.zeros(2, 37, 3 * 128 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):  # base one element off 16 bytes
        ak.tma_map("q", ak._heads(qkv[..., 1:129], 64))
    odd = torch.zeros(2, 37, 132, dtype=torch.bfloat16)[..., :128]  # rows of 264 bytes
    with pytest.raises(ValueError, match="TMA"):
        ak.tma_map("q", ak._heads(odd, 64))
    with pytest.raises(ValueError, match="TMA"):  # a strided last dim
        ak.tma_map("q", torch.zeros(2, 2, 37, 128, dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError, match="dh"):
        ak.tma_map("q", torch.zeros(2, 2, 37, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        ak.tma_map("q", torch.zeros(2, 2, 37, 64))
