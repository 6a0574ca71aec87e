"""The port's CUDA attention kernels on the card: each entry point's forward
and the backward kernels against their plain PyTorch versions at small and
ragged shapes, strided operands, the autograd Functions (outputs carry a
``grad_fn`` and their backward launches the kernel), and the wrapper's
input checks. These need an NVIDIA GPU with nvcc and skip
elsewhere; on a machine with a GPU run
``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: max |kernel - plain| <= 2e-2 * max |plain|, as in chip_smoke.py
(bf16 output against the fp32-softmax plain version: about 2.5 bf16 ulps at
the largest output)."""

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch.ops.attention_kernel import (
    attend_qkv,
    attention_packed_bwd_cuda,
    attention_packed_bwd_plain,
    attention_packed_cuda,
)
from sam3_lora_tpu_torch.ops.long_attention import (
    long_attention_packed,
    long_attention_packed_plain,
    long_attention_rope_packed,
)
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import (
    window_attention_rope_packed,
    window_attention_rope_packed_plain,
)

pytestmark = pytest.mark.cuda
RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, n, l, width):
    qkv = torch.randn(n, l, 3 * width, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]


def _assert_matches(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RTOL * ref.float().abs().max().item(), err


def _tables(l, dh):
    ang = np.random.RandomState(l).uniform(0, 6, (l, dh // 2)).astype(np.float32)
    return torch.tensor(np.cos(ang), device="cuda"), torch.tensor(np.sin(ang), device="cuda")


@pytest.mark.parametrize("l", [1, 37, 64, 100, 576])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32), (16, 64)])
def test_window_kernel_matches_plain(gen, l, p, dh):
    q, k, v = _qkv(gen, 3, l, p * dh)
    cos, sin = _tables(l, dh)
    before = window_attention_rope_packed.launches
    out = window_attention_rope_packed(q, k, v, dh ** -0.5, cos, sin)
    torch.cuda.synchronize()
    assert window_attention_rope_packed.launches == before + 1
    ref = window_attention_rope_packed_plain(q, k, v, dh ** -0.5, cos, sin)
    _assert_matches(out, ref)


@pytest.mark.parametrize("l", [77, 1000])
@pytest.mark.parametrize("p,dh", [(2, 64), (8, 32)])
def test_long_kernels_match_plain(gen, l, p, dh):
    q, k, v = (t.contiguous() for t in _qkv(gen, 2, l, p * dh))
    out = long_attention_packed(q, k, v, dh ** -0.5, dh)
    ref = long_attention_packed_plain(q, k, v, dh ** -0.5, dh)
    _assert_matches(out, ref)
    ang = compute_axial_freqs(dh, l, 1, scale_pos=1.0 / 3.0)
    cos, sin = (torch.tensor(f(ang), device="cuda") for f in (np.cos, np.sin))
    out = long_attention_rope_packed(q, k, v, dh ** -0.5, dh, cos, sin)
    ref = window_attention_rope_packed_plain(q, k, v, dh ** -0.5, cos, sin)
    _assert_matches(out, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = (t.contiguous() for t in _qkv(gen, 1, 16, 128))
    with pytest.raises(ValueError, match="bfloat16"):
        long_attention_packed(q.float(), k.float(), v.float(), 0.1, 32)
    with pytest.raises(ValueError, match="head_dim"):
        long_attention_packed(q, k, v, 0.1, 16)
    with pytest.raises(ValueError, match="aligned"):
        long_attention_packed(q[:, :, 1:97], k[:, :, 1:97], v[:, :, 1:97], 0.1, 32)
    with pytest.raises(ValueError, match="shape"):
        long_attention_packed(q, k[:, :8], v, 0.1, 32)


@pytest.mark.parametrize("l", [1, 37, 77, 100, 576])
@pytest.mark.parametrize("p,dh,rope", [(2, 64, True), (2, 64, False), (4, 32, True),
                                       (4, 32, False), (16, 64, True), (8, 32, False)])
def test_backward_kernels_match_plain(gen, l, p, dh, rope):
    q, k, v = _qkv(gen, 2, l, p * dh)
    cos, sin = _tables(l, dh) if rope else (None, None)
    o, lse = attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    grads = attention_packed_bwd_cuda(q, k, v, o, lse, do, dh ** -0.5, dh, cos, sin)
    torch.cuda.synchronize()
    refs = attention_packed_bwd_plain(q, k, v, o, do, dh ** -0.5, dh, cos, sin)
    if l == 1:
        # one key: P = 1, so dS = 0, and dq, dk are rounding noise on both
        # sides; they are held to the bound at the gradient's scale (max |dv|)
        scale = refs[2].float().abs().max().item()
        for g in grads[:2]:
            assert g.float().abs().max().item() <= RTOL * scale
        _assert_matches(grads[2], refs[2])
    else:
        for g, r in zip(grads, refs):
            _assert_matches(g, r)


@pytest.mark.parametrize("which", ["window", "long_rope", "long"])
def test_outputs_carry_grad_fn_and_backward_launches_the_kernel(gen, which):
    dh, p, l = (64, 2, 77) if which != "long" else (32, 4, 77)
    q, k, v = (t.contiguous().requires_grad_(True) for t in _qkv(gen, 2, l, p * dh))
    cos, sin = _tables(l, dh)
    entry, call = {
        "window": (window_attention_rope_packed,
                   lambda: window_attention_rope_packed(q, k, v, dh ** -0.5, cos, sin)),
        "long_rope": (long_attention_rope_packed,
                      lambda: long_attention_rope_packed(q, k, v, dh ** -0.5, dh, cos, sin)),
        "long": (long_attention_packed, lambda: long_attention_packed(q, k, v, dh ** -0.5, dh)),
    }[which]
    fwd, bwd = entry.launches, entry.bwd_launches
    out = call()
    assert out.requires_grad and out.grad_fn is not None
    assert entry.launches == fwd + 1
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert entry.bwd_launches == bwd + 1
    for t in (q, k, v):
        assert torch.isfinite(t.grad.float()).all() and t.grad.float().abs().max() > 0


def test_packed_qkv_gradient_is_one_tensor(gen):
    dh, p, l = 64, 16, 100
    qkv = torch.randn(3, l, 3 * p * dh, generator=gen, device="cuda").to(torch.bfloat16)
    qkv.requires_grad_(True)
    cos, sin = _tables(l, dh)
    bwd = window_attention_rope_packed.bwd_launches
    out = attend_qkv(window_attention_rope_packed, qkv, dh ** -0.5, dh, cos, sin)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert window_attention_rope_packed.bwd_launches == bwd + 1
    q, k, v = qkv.detach().chunk(3, dim=-1)
    refs = attention_packed_bwd_plain(q, k, v, out.detach(), do, dh ** -0.5, dh, cos, sin)
    for g, r in zip(qkv.grad.chunk(3, dim=-1), refs):
        _assert_matches(g, r)
