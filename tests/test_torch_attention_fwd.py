"""The attention forward's host side on the CPU, where its kernels cannot run:

* the rotation pass's plain version (``rope_plain``): bit for bit the
  port's ``apply_rope_half`` in bf16, within one bf16 ulp of the JAX
  ``apply_rope_half`` on the same bf16 values (XLA may fuse a multiply-add),
  and the same rotation the backward prep's plain version applies;
* the wrapper's checks (``fwd_plan``): every operand layout the main path
  and the probes hand the forward is admitted, with TMA maps of the
  extents, byte strides and slots the view has (the rotation's contiguous
  scratch in place of q and k with RoPE), packed operands planned as their
  head views; views the kernels cannot read raise (a misaligned base or
  row, a strided last dim, a stride TMA refuses), and the CUDA wrappers
  refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import rope as jax_rope
from sam3_lora_tpu_torch.ops import attention_kernel as ak
from sam3_lora_tpu_torch.ops import rope as port_rope
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.probes import pair_view


def _bf16_heads(rng, n, p, l, dh):
    return torch.from_numpy(rng.standard_normal((n, p, l, dh)).astype(np.float32)).to(torch.bfloat16)


def _tables(l, dh):
    ang = compute_axial_freqs(dh, l, 1, scale_pos=1.0 / 3.0).astype(np.float32)
    return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


@pytest.mark.parametrize("l", [1, 37, 100])
@pytest.mark.parametrize("dh", [32, 64])
def test_rope_plain_equals_apply_rope_half(l, dh):
    rng = np.random.RandomState(l + dh)
    q, k, o, do = (_bf16_heads(rng, 2, 3, l, dh) for _ in range(4))
    cos, sin = _tables(l, dh)
    q_rot, k_rot = ak.rope_plain(q, k, cos, sin)
    assert q_rot.dtype == k_rot.dtype == torch.bfloat16
    assert torch.equal(q_rot, port_rope.apply_rope_half(q, cos, sin))
    assert torch.equal(k_rot, port_rope.apply_rope_half(k, cos, sin))
    # the backward's prep rotates with the same function
    prep_q, prep_k, _ = ak.attention_bwd_prep_plain(q, k, o, do, cos, sin)
    assert torch.equal(prep_q, q_rot) and torch.equal(prep_k, k_rot)
    for got, x in ((q_rot, q), (k_rot, k)):
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        ref = np.asarray(jax_rope.apply_rope_half(xj, jnp.asarray(cos.numpy()),
                                                  jnp.asarray(sin.numpy())), np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def _forward_layouts():
    """(name, (N, P, L, dh) view) of every operand layout the forward is
    handed, at L = 37: the packed qkv column blocks (K1, K2, W-qkv), the
    encoder's (N, L, 256) at dh 32 (K3), K1''s head pairs, W-g's strided
    head-major views of the qkv output, W-p's pair views of them, and the
    probes' (N/2, 2, L, 64) heads and the pair view of an (N, L, 128)
    tensor."""
    n, l, heads, dh = 2, 37, 4, 64
    qkv = torch.zeros(n, l, 3 * heads * dh, dtype=torch.bfloat16)
    cols = qkv.chunk(3, -1)
    views = [("packed_q", ak._heads(cols[0], dh)), ("packed_k", ak._heads(cols[1], dh)),
             ("packed_v", ak._heads(cols[2], dh)),
             ("encoder", ak._heads(torch.zeros(n, l, 256, dtype=torch.bfloat16), 32))]
    pairs = cols[1].reshape(n, l, heads // 2, 2 * dh).transpose(1, 2).reshape(-1, l, 2 * dh)
    views.append(("k1_pairs", ak._heads(pairs.contiguous(), dh)))
    grouped = qkv.reshape(n, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    views += [("w_g", grouped[0]), ("w_p", grouped[1].reshape(n * heads // 2, 2, l, dh)),
              ("probe_heads", torch.zeros(n, 2, l, dh, dtype=torch.bfloat16)),
              ("probe_pair", pair_view(torch.zeros(n, l, 2 * dh, dtype=torch.bfloat16)))]
    return views


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("name,view", _forward_layouts(), ids=[n for n, _ in _forward_layouts()])
def test_fwd_plan_admits_every_forward_layout(name, view, rope):
    n, p, l, dh = view.shape
    cos, sin = _tables(l, dh) if rope else (None, None)
    o = torch.empty(view.shape, dtype=view.dtype)
    plan = ak.fwd_plan(view, view, view, o, None, cos, sin)
    assert (plan.n, plan.p, plan.l, plan.dh) == (n, p, l, dh)
    assert list(plan.strides) == list(view.stride()[:3]) * 2 + list(o.stride()[:3])
    # with RoPE the main kernel reads the rotation's contiguous scratch
    qk = torch.empty(view.shape, dtype=view.dtype) if rope else view
    flat = list(plan.maps)
    assert len(flat) == 24
    for i, t in enumerate((qk, qk, view)):
        assert flat[8 * i:8 * i + 8] == ak.tma_map("x", t)
    spec = flat[16:24]  # v's: each dimension with its extent and byte stride
    where = {"l": spec[6] & 15, "p": (spec[6] >> 4) & 15, "n": (spec[6] >> 8) & 15}
    for dim, size, stride in (("n", n, view.stride(0)), ("p", p, view.stride(1)),
                              ("l", l, view.stride(2))):
        assert spec[where[dim] - 1] == size
        if size > 1:
            assert spec[3 + where[dim] - 1] == 2 * stride


def test_fwd_plan_of_packed_operands_is_their_head_views():
    qkv = torch.zeros(2, 37, 3 * 256, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    o = torch.empty(q.shape, dtype=q.dtype)
    for dh in (32, 64):
        packed = ak.fwd_plan(q, k, v, o, dh)
        views = ak.fwd_plan(*(ak._heads(t, dh) for t in (q, k, v, o)))
        assert list(packed.maps) == list(views.maps)
        assert list(packed.strides) == list(views.strides)
    with pytest.raises(ValueError, match="P\\*48"):
        ak.fwd_plan(q, k, v, o, 48)


def test_fwd_plan_refuses_views_the_kernels_cannot_read():
    qkv = torch.zeros(2, 37, 3 * 128 + 8, dtype=torch.bfloat16)
    q = ak._heads(qkv[..., :128], 64)
    o = torch.empty(q.shape, dtype=q.dtype)
    with pytest.raises(ValueError, match="aligned"):  # base one element off 16 bytes
        ak.fwd_plan(ak._heads(qkv[..., 1:129], 64), q, q, o)
    odd = ak._heads(torch.zeros(2, 37, 132, dtype=torch.bfloat16)[..., :128], 64)
    with pytest.raises(ValueError, match="aligned"):  # rows of 264 bytes
        ak.fwd_plan(q, q, odd, o)
    with pytest.raises(ValueError, match="aligned"):  # the output too
        ak.fwd_plan(q, q, q, odd)
    broadcast = ak._heads(torch.zeros(1, 37, 128, dtype=torch.bfloat16).expand(2, -1, -1), 64)
    with pytest.raises(ValueError, match="TMA"):  # a sequence stride of 0
        ak.fwd_plan(q, q, broadcast, o)
    with pytest.raises(ValueError, match="TMA"):  # k read in place without tables
        ak.fwd_plan(q, broadcast, q, o)
    cos, sin = _tables(37, 64)
    # with tables q and k are read by the rotation pass, not by TMA
    ak.fwd_plan(q, broadcast, q, o, None, cos, sin)
    with pytest.raises(ValueError, match="cos"):
        ak.fwd_plan(q, q, q, o, None, cos[:5], sin[:5])
    with pytest.raises(ValueError, match="together"):
        ak.fwd_plan(q, q, q, o, None, cos, None)
    with pytest.raises(ValueError, match="head_dim"):
        ak.fwd_plan(*(torch.zeros(2, 2, 37, 16, dtype=torch.bfloat16) for _ in range(4)))


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 37, 64, dtype=torch.bfloat16)
    cos, sin = _tables(37, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ak.attention_cuda(q, q, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        ak.rope_cuda(q, q, cos, sin)
