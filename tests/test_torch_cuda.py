"""The port's CUDA kernels on the card: each attention entry point's forward
and the backward kernels against their plain PyTorch versions at small and
ragged shapes, strided operands, the autograd Functions (outputs carry a
``grad_fn`` and their backward launches the kernel), and the wrapper's
input checks; the int8 tier's K4/K5/K6 (``ops/gemm_int8.py``) against their
plain versions at the model's K x N, their counters, the routing of the
autograd Functions and the wrapper's checks. These need an NVIDIA GPU with
nvcc and skip elsewhere; on a machine with a GPU run
``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: attention max |kernel - plain| <= 2e-2 * max |plain|, as in
chip_smoke.py (bf16 output against the fp32-softmax plain version: about 2.5
bf16 ulps at the largest output). K4 is held equal bit for bit (the same
int8 values, an exact int32 sum, the same fp32 scaling); K5 and K6 within
8e-3 * max |plain|, one bf16 ulp of the largest output (the bf16 products'
sums run in another order)."""

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch.ops import gemm_int8, quant
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


GEMM_RTOL = 8e-3
VIT_KN = [(1024, 3072), (1024, 1024), (1024, 4736), (4736, 1024)]  # qkv, proj, fc1, fc2
TEXT_KN = [(1024, 4096), (4096, 1024)]  # c_fc, c_proj (out_proj is 1024 x 1024)
ROWS = [1, 37, 96, 1000, 5184]


def _int8_operands(gen, m, k, n, r=0):
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5
    wq, ws = quant.quantize_weight(w)
    a = (0.1 * torch.randn(r, k, generator=gen, device="cuda")).to(torch.bfloat16)
    b = (0.1 * torch.randn(n, r, generator=gen, device="cuda")).to(torch.bfloat16)
    return x, wq, ws, a, b


def _assert_gemm_close(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= GEMM_RTOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", VIT_KN + TEXT_KN)
def test_k4_equals_plain_bit_for_bit(gen, m, k, n):
    x, wq, ws, _, _ = _int8_operands(gen, m, k, n)
    before = gemm_int8.int8_gemm_wres.launches
    out = gemm_int8.int8_gemm_wres(x, wq, ws)
    torch.cuda.synchronize()
    assert gemm_int8.int8_gemm_wres.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert torch.equal(out, gemm_int8.int8_gemm_wres_plain(x, wq, ws))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", VIT_KN + TEXT_KN)
def test_k5_matches_plain(gen, m, k, n):
    r = 8 if m % 2 else 32
    x, wq, ws, a, b = _int8_operands(gen, m, k, n, r)
    before = gemm_int8.int8_lora_gemm_wres.launches
    out = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 2.0)
    torch.cuda.synchronize()
    assert gemm_int8.int8_lora_gemm_wres.launches == before + 1
    _assert_gemm_close(out, gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, 2.0))


@pytest.mark.parametrize("r", [16, 24, 64])
def test_k5_other_ranks(gen, r):
    x, wq, ws, a, b = _int8_operands(gen, 1000, 1024, 4736, r)
    out = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 0.5)
    _assert_gemm_close(out, gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, 0.5))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", VIT_KN + TEXT_KN)
def test_k6_matches_plain(gen, m, k, n):
    _, wq, ws, _, _ = _int8_operands(gen, 1, k, n)
    dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    before = gemm_int8.bf16_gemm_wres_nt.launches
    out = gemm_int8.bf16_gemm_wres_nt(dy, wq, ws)
    torch.cuda.synchronize()
    assert gemm_int8.bf16_gemm_wres_nt.launches == before + 1
    assert out.shape == (m, k)
    _assert_gemm_close(out, gemm_int8.bf16_gemm_wres_nt_plain(dy, wq, ws))


@pytest.mark.parametrize("bwd_kernel", [False, True])
def test_int8_functions_carry_grad_fn_and_route_dx(gen, bwd_kernel, monkeypatch):
    """int8_matmul_prequant on the card: K4 forward; its dx goes to K6 when
    GEMM_BWD_KERNEL is on and the width gate passes (fc1's 1024 x 4736)."""
    monkeypatch.setattr(gemm_int8, "GEMM_BWD_KERNEL", bwd_kernel)
    x, wq, ws, _, _ = _int8_operands(gen, 2 * 96, 1024, 4736)
    x = x.reshape(2, 96, 1024).requires_grad_(True)
    k4, k6 = gemm_int8.int8_gemm_wres.launches, gemm_int8.bf16_gemm_wres_nt.launches
    y = quant.int8_matmul_prequant(x, wq, ws)
    assert y.grad_fn is not None and y.shape == (2, 96, 4736)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(torch.bfloat16)
    y.backward(dy)
    torch.cuda.synchronize()
    assert gemm_int8.int8_gemm_wres.launches == k4 + 1
    assert gemm_int8.bf16_gemm_wres_nt.launches == k6 + int(bwd_kernel)
    ref = gemm_int8.bf16_gemm_wres_nt_plain(dy.reshape(-1, 4736), wq, ws).reshape(x.shape)
    _assert_gemm_close(x.grad, ref)


def test_fused_function_grads_on_the_card(gen):
    x, wq, ws, a, b = _int8_operands(gen, 300, 1024, 3072, 8)
    x.requires_grad_(True)
    la, lb = a.float().requires_grad_(True), b.float().requires_grad_(True)
    before = gemm_int8.int8_lora_gemm_wres.launches
    y = quant.int8_lora_matmul_prequant(x, wq, ws, la, lb, 2.0)
    assert y.grad_fn is not None and gemm_int8.int8_lora_gemm_wres.launches == before + 1
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    for t in (x.grad, la.grad, lb.grad):
        assert torch.isfinite(t.float()).all() and t.float().abs().max() > 0


def test_gemm_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, wq, ws, a, b = _int8_operands(gen, 64, 1024, 1024, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gemm_int8.int8_gemm_wres_cuda(x.cpu(), wq, ws)
    with pytest.raises(ValueError, match="K % 32"):
        gemm_int8.int8_gemm_wres_cuda(x[:, :1000].contiguous(), wq[:, :1000].contiguous(), ws)
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_int8.int8_gemm_wres_cuda(x.float(), wq, ws)
    with pytest.raises(ValueError, match="rank"):
        gemm_int8.int8_lora_gemm_wres_cuda(x, wq, ws, a[:4], b[:, :4], 1.0)
    with pytest.raises(ValueError, match="K % 32"):
        gemm_int8.bf16_gemm_wres_nt_cuda(x[:, :1000].contiguous(), wq[:, :1000].contiguous(), ws)
