"""The port's CUDA kernels on the card: each attention entry point's forward
and the backward kernels against their plain PyTorch versions at small and
ragged shapes, strided operands, the autograd Functions (outputs carry a
``grad_fn`` and their backward launches the kernel), and the wrapper's
input checks; the int8 tier's K4/K5/K6 (``ops/gemm_int8.py``) against their
plain versions at the model's K x N and at every shape of
``chip_smoke.gemm_cases()``, K4's and K6's first passes (the row
quantization, the dequantize-transpose) against theirs, the counters, the
routing of the autograd Functions and the wrappers' checks. The backward
is also held deterministic (two launches, equal bits) and its prep pass
bit for bit equal to its plain version; so is the forward (two launches,
its log-sum-exp against the plain one, its rotation pass bit for bit). These need an NVIDIA GPU with
nvcc and skip elsewhere; on a machine with a GPU run
``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: attention max |kernel - plain| <= 2e-2 * max |plain|, as in
chip_smoke.py (bf16 output against the fp32-softmax plain version: about 2.5
bf16 ulps at the largest output). K4 is held equal bit for bit (the same
int8 values, an exact int32 sum, the same fp32 scaling); K5 and K6 within
8e-3 * max |plain|, one bf16 ulp of the largest output (the bf16 products'
sums run in another order). The window-kernel probes (``ops/probe_kernels.py``):
every stage rung and op rate against its plain version (the op rates also
at passes around the kernel's unroll and ragged row counts, with their
launch layout and their SASS against ``window_cost.OP_MIX``), the full rung
bit for bit equal to the production forward, the packed layout's
backward. The serving path's mask IoU and NMS (``ops/masks.py``,
``ops/nms.py``, and chip_smoke's device loop) on the card, bit for bit the
CPU's. The interactive predictor's SAM heads on the card against their fp32
CPU run, and the decoder's dense boxRPB oracle against its separable route,
at the full width (``chip_smoke.SMALL_TOL``). The video tier: the auction
and the batched connected components (and the hole filling) on the card,
bit for bit the CPU's; the tracker's propagate and memory update at the
full width against their fp32 CPU run (``chip_smoke.SMALL_TOL``). Scale-out:
two gloo ranks on the one card (the trainer's bucketed mean and broadcast,
the frame-parallel all-gather on CUDA tensors), and the frame-parallel
detector at one rank against each frame alone."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from sam3_lora_tpu_torch import probes
from sam3_lora_tpu_torch.ops import (
    attention_kernel, gemm_int8, probe_kernels, quant, window_attention, window_qkv,
)
from sam3_lora_tpu_torch.ops.attention import dot_product_attention
from sam3_lora_tpu_torch.ops.attention_kernel import (
    attend_qkv,
    attention_bwd_plain,
    attention_bwd_prep_cuda,
    attention_bwd_prep_plain,
    attention_packed_bwd_cuda,
    attention_packed_bwd_plain,
    attention_packed_cuda,
    attention_plain,
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


LSE_ATOL = chip_smoke.LSE_ATOL  # natural-log units: bf16-rounded rotated q, k


def _assert_lse(q, k, v, dh, cos, sin):
    """The forward's log-sum-exp (as training asks for it) against the plain
    one of the same (rotated) scores; its output equal to the no-lse call's."""
    o, lse = attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin, with_lse=True)
    torch.cuda.synchronize()
    qh, kh = (attention_kernel._heads(t, dh) for t in (q, k))
    if cos is not None:
        qh, kh = attention_kernel.rope_plain(qh, kh, cos, sin)
    ref = torch.logsumexp(torch.einsum("npqd,npkd->npqk", qh.float(), kh.float()) * dh ** -0.5, -1)
    assert (lse - ref).abs().max().item() <= LSE_ATOL
    assert torch.equal(o, attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin))


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
    _assert_lse(q, k, v, dh, cos, sin)


@pytest.mark.parametrize("l", [77, 1000])
@pytest.mark.parametrize("p,dh", [(2, 64), (8, 32)])
def test_long_kernels_match_plain(gen, l, p, dh):
    q, k, v = (t.contiguous() for t in _qkv(gen, 2, l, p * dh))
    out = long_attention_packed(q, k, v, dh ** -0.5, dh)
    ref = long_attention_packed_plain(q, k, v, dh ** -0.5, dh)
    _assert_matches(out, ref)
    _assert_lse(q, k, v, dh, None, None)
    ang = compute_axial_freqs(dh, l, 1, scale_pos=1.0 / 3.0)
    cos, sin = (torch.tensor(f(ang), device="cuda") for f in (np.cos, np.sin))
    out = long_attention_rope_packed(q, k, v, dh ** -0.5, dh, cos, sin)
    ref = window_attention_rope_packed_plain(q, k, v, dh ** -0.5, cos, sin)
    _assert_matches(out, ref)
    _assert_lse(q, k, v, dh, cos, sin)


@pytest.mark.parametrize("l", [1, 37, 576, 1000])
@pytest.mark.parametrize("p,dh,rope", [(2, 64, True), (2, 64, False), (4, 32, True),
                                       (8, 32, False)])
def test_forward_kernels_are_deterministic(gen, l, p, dh, rope):
    q, k, v = _qkv(gen, 2, l, p * dh)
    cos, sin = _tables(l, dh) if rope else (None, None)
    first = attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin, with_lse=True)
    second = attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin, with_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("l", [1, 37, 576])
@pytest.mark.parametrize("p,dh", [(2, 64), (16, 64), (4, 32)])
def test_rope_pass_equals_plain(gen, l, p, dh):
    """The forward's rotation pass, on strided column views of a packed qkv,
    bit for bit its plain version (and the backward prep's rotation)."""
    q, k = (attention_kernel._heads(t, dh) for t in _qkv(gen, 2, l, p * dh)[:2])
    cos, sin = _tables(l, dh)
    before = attention_kernel.rope_cuda.launches
    got = attention_kernel.rope_cuda(q, k, cos, sin)
    torch.cuda.synchronize()
    assert attention_kernel.rope_cuda.launches == before + 1
    for a, b in zip(got, attention_kernel.rope_plain(q, k, cos, sin)):
        assert a.is_contiguous() and torch.equal(a, b)


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
    # views TMA refuses: a sequence stride of 0 (one k broadcast over N),
    # rows of 264 bytes
    qq, kk, vv = (t.contiguous() for t in _qkv(gen, 2, 16, 128))
    with pytest.raises(ValueError, match="TMA"):
        long_attention_packed(qq, kk[:1].expand(2, -1, -1), vv, 0.1, 32)
    odd = torch.randn(2, 16, 132, generator=gen, device="cuda").to(torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="aligned"):
        long_attention_packed(qq, kk, odd, 0.1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        attention_kernel.attention_cuda(*(attention_kernel._heads(t.cpu(), 32) for t in (q, k, v)),
                                        0.1)


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


BWD_CASES = [(2, 64, True), (2, 64, False), (4, 32, True), (8, 32, False)]


@pytest.mark.parametrize("l", [37, 576, 1000])
@pytest.mark.parametrize("p,dh,rope", BWD_CASES)
def test_backward_kernels_are_deterministic(gen, l, p, dh, rope):
    q, k, v = _qkv(gen, 2, l, p * dh)
    cos, sin = _tables(l, dh) if rope else (None, None)
    o, lse = attention_packed_cuda(q, k, v, dh ** -0.5, dh, cos, sin, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    first = attention_packed_bwd_cuda(q, k, v, o, lse, do, dh ** -0.5, dh, cos, sin)
    second = attention_packed_bwd_cuda(q, k, v, o, lse, do, dh ** -0.5, dh, cos, sin)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("l", [1, 37, 576])
@pytest.mark.parametrize("p,dh,rope", BWD_CASES)
def test_backward_prep_kernel_equals_plain(gen, l, p, dh, rope):
    views = [attention_kernel._heads(t, dh) for t in _qkv(gen, 2, l, p * dh)]
    o, do = (attention_kernel._heads(t, dh) for t in _qkv(gen, 2, l, p * dh)[:2])
    lse = torch.randn(2, p, l, generator=gen, device="cuda")
    cos, sin = _tables(l, dh) if rope else (None, None)
    got = attention_bwd_prep_cuda(views[0], views[1], o, do, lse, cos, sin)
    torch.cuda.synchronize()
    ref = attention_bwd_prep_plain(views[0], views[1], o, do, cos, sin)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_backward_wrapper_raises_on_refused_views(gen):
    q, k, v = (t.contiguous() for t in _qkv(gen, 1, 40, 128))
    o, lse = attention_packed_cuda(q, k, v, 0.125, 64, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    wide = torch.randn(1, 40, 136, generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):  # base one element off 16 bytes
        attention_packed_bwd_cuda(wide[..., 1:129], k, v, o, lse, do, 0.125, 64)
    odd = torch.randn(1, 40, 132, generator=gen, device="cuda").to(torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="aligned"):  # rows of 264 bytes
        attention_packed_bwd_cuda(q, odd, v, o, lse, do, 0.125, 64)
    with pytest.raises(ValueError, match="aligned"):  # an output TMA-free but misaligned
        attention_packed_bwd_cuda(q, k, v, o, lse, do, 0.125, 64, out=(odd, q.clone(), q.clone()))
    with pytest.raises(ValueError, match="lse"):
        attention_packed_bwd_cuda(q, k, v, o, lse.transpose(1, 2), do, 0.125, 64)


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


WINDOW_ROUTES = ("packed", "grouped", "rope_grouped", "pair_packed", "rope_pair_packed",
                 "qkv", "rope_qkv")
WINDOW_ENTRIES = window_attention.ENTRIES + (window_qkv.window_attention_qkv,
                                             window_qkv.window_attention_rope_qkv)


def _window_route(name, qkv, heads, cos, sin):
    """(entry, output as (N, H, L, dh)) of one window route on the
    (N, L, 3*H*dh) tensor ``qkv``: K1' on (N*H/2, L, 2*dh) pairs copied out
    of it, W-g and W-p on (N, H, L, dh) views of it, W-qkv on the tensor."""
    n, l, td = qkv.shape
    dh = td // (3 * heads)
    scale = dh ** -0.5
    rope = (cos, sin) if name.startswith("rope") else ()
    if name in ("qkv", "rope_qkv"):
        entry = getattr(window_qkv, f"window_attention_{name}")
        return entry, entry(qkv, heads, scale, *rope).reshape(n, l, heads, dh).transpose(1, 2)
    if name == "packed":
        q, k, v = (t.reshape(n, l, heads // 2, 2 * dh).transpose(1, 2).reshape(-1, l, 2 * dh)
                   .contiguous() for t in qkv.chunk(3, dim=-1))
        out = window_attention.window_attention_packed(q, k, v, scale)
        out = out.reshape(n, heads // 2, l, 2, dh).transpose(2, 3).reshape(n, heads, l, dh)
        return window_attention.window_attention_packed, out
    views = qkv.reshape(n, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    entry = getattr(window_attention, f"window_attention_{name}")
    return entry, entry(*views, scale, *rope)


@pytest.mark.parametrize("l", [37, 576])
@pytest.mark.parametrize("name", WINDOW_ROUTES)
def test_window_routes_match_plain_forward_and_backward(gen, name, l):
    """K1', W-g, W-p and W-qkv (with and without RoPE): forward and, through
    autograd, the backward kernels against the plain versions, each counted
    on its own entry, once."""
    heads, dh = 4, 64
    qkv = torch.randn(3, l, 3 * heads * dh, generator=gen, device="cuda").to(torch.bfloat16)
    qkv.requires_grad_(True)
    cos, sin = _tables(l, dh)
    rope = (cos, sin) if name.startswith("rope") else (None, None)
    for e in WINDOW_ENTRIES:
        e.launches = e.bwd_launches = 0
    entry, out = _window_route(name, qkv, heads, cos, sin)
    assert out.grad_fn is not None
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    counts = {e.__name__: (e.launches, e.bwd_launches) for e in WINDOW_ENTRIES}
    assert counts.pop(entry.__name__) == (1, 1)
    assert set(counts.values()) == {(0, 0)}
    views = qkv.detach().reshape(3, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    _assert_matches(out, attention_plain(*views, dh ** -0.5, *rope))
    refs = attention_bwd_plain(*views, out.detach(), do, dh ** -0.5, *rope)
    grads = qkv.grad.reshape(3, l, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    for g, r in zip(grads, refs):
        _assert_matches(g, r)


def test_dot_product_attention_window_impl_routes_to_the_kernels(gen, monkeypatch):
    """``impl="window"`` on CUDA tensors takes W-p, or W-g with ``_PACKED``
    off; the grid of W-g at batch 8 (1152 heads) launches."""
    q, k, v = (torch.randn(72, 16, 576, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    cos, sin = _tables(576, 64)
    for packed, entry in ((True, window_attention.window_attention_rope_pair_packed),
                          (False, window_attention.window_attention_rope_grouped)):
        monkeypatch.setattr(window_attention, "_PACKED", packed)
        before = entry.launches
        out = dot_product_attention(q, k, v, impl="window", rope_cos=cos, rope_sin=sin)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        _assert_matches(out, attention_plain(q, k, v, 64 ** -0.5, cos, sin))


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


@pytest.mark.parametrize("m", [1, 16, 17, 1000])
@pytest.mark.parametrize("r", [8, 24, 40, 64])
def test_k5_ranks_at_ragged_rows(gen, r, m):
    """The low-rank step at every rank class (one to four k16 steps, the
    columns past r zero-filled) on fc1's ragged N tile (4736 = 18.5 x 256)
    and ragged M."""
    x, wq, ws, a, b = _int8_operands(gen, m, 1024, 4736, r)
    out = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 1.5)
    torch.cuda.synchronize()
    assert out.shape == (m, 4736)
    _assert_gemm_close(out, gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, 1.5))


@pytest.mark.parametrize("m,k,n,r", [(17, 32, 8, 8), (300, 96, 264, 24), (130, 8192, 520, 64)])
def test_k5_small_and_long_contractions(gen, m, k, n, r):
    """One and three K blocks a tile (the low-rank operands loaded after the
    last K stage), a long K (the first pass's warps walk many steps), ragged
    M and N tiles."""
    x, wq, ws, a, b = _int8_operands(gen, m, k, n, r)
    out = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 0.5)
    torch.cuda.synchronize()
    _assert_gemm_close(out, gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, 0.5))


def test_k5_two_launches_equal_bits_and_k4_after_it(gen):
    """K5 is deterministic (two launches, equal bits), and K4 on the same
    stream after it still equals its plain version bit for bit."""
    x, wq, ws, a, b = _int8_operands(gen, 5184, 1024, 4736, 32)
    first = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 2.0)
    second = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 2.0)
    y = gemm_int8.int8_gemm_wres(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(y, gemm_int8.int8_gemm_wres_plain(x, wq, ws))
    _assert_gemm_close(first, gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, 2.0))


@pytest.mark.parametrize("m", [1, 37, 1000, 5184])
@pytest.mark.parametrize("k,n", [(1024, 3072), (4736, 1024)])
def test_k5_with_zero_lora_b_equals_k4_bit_for_bit(gen, m, k, n):
    """K5's first pass quantizes x with K4's bits and its mainloop scales the
    sums as K4's does: with lora_b = 0 the output is K4's, bit for bit."""
    x, wq, ws, a, b = _int8_operands(gen, m, k, n, 16)
    out = gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, torch.zeros_like(b), 1.5)
    torch.cuda.synchronize()
    assert torch.equal(out, gemm_int8.int8_gemm_wres(x, wq, ws))


def test_k5_rejects_a_rank_over_64(gen):
    x, wq, ws, a, b = _int8_operands(gen, 64, 1024, 1024, 72)
    before = gemm_int8.int8_lora_gemm_wres.launches
    with pytest.raises(ValueError, match="rank"):
        gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 1.0)
    assert gemm_int8.int8_lora_gemm_wres.launches == before


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


GEMM_CASES = chip_smoke.gemm_cases()
GEMM_IDS = [f"{layer}-{path}-M{m}" for layer, path, m, _, _ in GEMM_CASES]


@pytest.mark.parametrize("layer,path,m,k,n", GEMM_CASES, ids=GEMM_IDS)
def test_k4_bit_exact_at_main_path_shapes(gen, layer, path, m, k, n):
    """Every int8 GEMM of the main paths (serving, training, bench.py's batch
    8, the text encoder, a ragged M): K4 bit for bit."""
    x, wq, ws, _, _ = _int8_operands(gen, m, k, n)
    out = gemm_int8.int8_gemm_wres(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(out, gemm_int8.int8_gemm_wres_plain(x, wq, ws))


@pytest.mark.parametrize("layer,path,m,k,n", [c for c in GEMM_CASES if c[0] in ("fc1", "fc2")],
                         ids=[i for i, c in zip(GEMM_IDS, GEMM_CASES) if c[0] in ("fc1", "fc2")])
def test_k6_within_bound_at_main_path_shapes(gen, layer, path, m, k, n):
    """K6 at fc1's and fc2's dx shapes of the main paths."""
    _, wq, ws, _, _ = _int8_operands(gen, 1, k, n)
    dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    out = gemm_int8.bf16_gemm_wres_nt(dy, wq, ws)
    torch.cuda.synchronize()
    _assert_gemm_close(out, gemm_int8.bf16_gemm_wres_nt_plain(dy, wq, ws))


@pytest.mark.parametrize("m,k", [(1, 1024), (37, 4096), (1000, 1024), (5184, 4736)])
def test_quant_rows_kernel_equals_plain(gen, m, k):
    """K4's first pass: the int8 rows and their scales bit for bit, a zero
    row and a row of .5 ties (round half to even) included."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    x[0] = 0.0
    if m > 1:
        x[1] = 0.0
        x[1, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -0.5])
    xq, sx = gemm_int8.quant_rows_cuda(x)
    torch.cuda.synchronize()
    ref_q, ref_s = gemm_int8.quant_rows(x)
    assert torch.equal(xq, ref_q) and torch.equal(sx, ref_s[:, 0])


@pytest.mark.parametrize("k,n", VIT_KN + TEXT_KN + [(160, 96)])
def test_dequantize_t_kernel_equals_plain(gen, k, n):
    """K6's first pass: W_deq^T bit for bit, ragged tiles included."""
    _, wq, ws, _, _ = _int8_operands(gen, 1, k, n)
    out = gemm_int8.dequantize_t_cuda(wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(out, gemm_int8.dequantize_t(wq, ws, torch.bfloat16))


def test_k4_k6_wrappers_raise_on_refused_shapes(gen):
    """What the mainloops refuse raises before any launch: K4 at K % 32 != 0
    or N % 8 != 0, K6 at N % 32 != 0 or K % 32 != 0, each pre-pass alike."""
    x, wq, ws, _, _ = _int8_operands(gen, 64, 1024, 1024)
    k4, k6 = gemm_int8.int8_gemm_wres.launches, gemm_int8.bf16_gemm_wres_nt.launches
    with pytest.raises(ValueError, match="K % 32"):
        gemm_int8.int8_gemm_wres(x[:, :1008].contiguous(), wq[:, :1008].contiguous(), ws)
    with pytest.raises(ValueError, match="N % 8"):
        gemm_int8.int8_gemm_wres(x, wq[:1004].contiguous(), ws[:1004].contiguous())
    with pytest.raises(ValueError, match="K % 32"):
        gemm_int8.quant_rows_cuda(x[:, :1000].contiguous())
    with pytest.raises(ValueError, match="N % 32"):
        gemm_int8.bf16_gemm_wres_nt(x[:, :1008].contiguous(), wq[:1008], ws[:1008])
    with pytest.raises(ValueError, match="N % 32"):
        gemm_int8.dequantize_t_cuda(wq[:1000].contiguous(), ws[:1000].contiguous())
    with pytest.raises(ValueError, match="K % 32"):
        gemm_int8.dequantize_t_cuda(wq[:, :1000].contiguous(), ws)
    assert (gemm_int8.int8_gemm_wres.launches, gemm_int8.bf16_gemm_wres_nt.launches) == (k4, k6)


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


@pytest.mark.parametrize("m", [5, 96, 1000])
def test_int8_bwd_dx_on_the_card_equals_plain(gen, m):
    """The ``int8_bwd`` dx through ``torch._int_mm`` equals the CPU's exact
    sum bit for bit (M <= 16 padded)."""
    _, wq, ws, _, _ = _int8_operands(gen, 1, 1024, 4736)
    dy = torch.randn(m, 4736, generator=gen, device="cuda").to(torch.bfloat16)
    out = quant.dx_int8(dy, wq, ws)
    assert out.dtype == torch.bfloat16 and out.shape == (m, 1024)
    assert torch.equal(out.cpu(), quant.dx_int8(dy.cpu(), wq.cpu(), ws.cpu()))


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


# ---- the window-kernel probes (ops/probe_kernels.py, csrc/probe_window.cu)

def _heads(gen, n, p, l):
    return [torch.randn(n, p, l, 64, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("l", [100, 576])
@pytest.mark.parametrize("name", probe_kernels.STAGES)
def test_probe_stages_match_plain(gen, name, l):
    """Every rung, per head and (where it has one) in the block-diagonal
    pair form, at 1 and several heads (pairs) per CTA; a ragged L too.
    Copies bit for bit, the rest within RTOL; the per-head rung at 4 heads
    per CTA (the sweep kernel) bit for bit equal to the forward kernel's
    instance at 1, as both run the forward's body."""
    q, k, v = _heads(gen, 4, 2, l)
    ref = probe_kernels.stage_plain(q, k, v, name, 0.125)
    forms = [(False, 1), (False, 4)]
    if name in probe_kernels.PAIR_STAGES:
        forms += [(True, 1), (True, 2)]
    outs = {}
    for pair, wpc in forms:
        out = outs[pair, wpc] = probe_kernels.stage(q, k, v, name, 0.125, pair=pair, wpc=wpc)
        torch.cuda.synchronize()
        if name == "copy":
            assert torch.equal(out, ref), (pair, wpc)
        else:
            _assert_matches(out, ref)
    assert torch.equal(outs[False, 4], outs[False, 1])


@pytest.mark.parametrize("l", [100, 576])
def test_probe_full_rung_equals_attention_cuda(gen, l):
    """The full rung is the production forward: bit for bit."""
    q, k, v = _heads(gen, 8, 2, l)
    out = probe_kernels.stage(q, k, v, "full", 0.125)
    assert torch.equal(out, attention_kernel.attention_cuda(q, k, v, 0.125))


@pytest.mark.parametrize("name", probe_kernels.OPS)
def test_probe_ops_match_plain(gen, name):
    """One 576 x 576 tile at 64 passes: fp32 within 1e-5 relative, bf16
    within one ulp of the largest output."""
    x = (torch.randn(576, 576, generator=gen, device="cuda").abs() + 0.5)
    x = x.to(probe_kernels.op_dtype(name))
    out = probe_kernels.op_rate(x, name, 64)
    ref = probe_kernels.op_plain(x, name, 64)
    err, limit, ok = probes.compare(out, ref, "bf16" if name.endswith("bf16") else "op32")
    assert ok, (err, limit)


@pytest.mark.parametrize("name", probe_kernels.OPS)
def test_probe_op_passes_and_rows(gen, name):
    """Each op against op_plain at passes 0, 1, U - 1, U and 3U + 1 (U the
    kernel's unroll: the main loop and its tail), at row counts that do not
    divide the resident warps (1, an odd 577, and 20001, over the row pairs
    the grid holds at once, so warps take a second pair); two launches give
    equal bits. On the script's input (>= 0.5) maxreduce and add_bf16 leave
    every value as it is, so those two also run on
    ``window_cost.op_moving_input``, where every pass moves the values,
    bit for bit against op_plain (the same two roundings: y + fl(max *
    1e-9); bf16(y + bf16(1e-3)), exact in fp32 before its one rounding)."""
    from sam3_lora_tpu_torch.probes import window_cost

    u = probe_kernels.op_layout(name, 1)["unroll"]
    for rows in (1, 577, 20001):
        x = (torch.randn(rows, 576, generator=gen, device="cuda").abs() + 0.5)
        inputs = [(x.to(probe_kernels.op_dtype(name)), "bf16" if name.endswith("bf16") else "op32")]
        if name in ("maxreduce_f32", "add_bf16"):
            inputs.append((window_cost.op_moving_input(gen, name, rows), "exact"))
        for x, rule in inputs:
            for passes in (0, 1, u - 1, u, 3 * u + 1):
                out = probe_kernels.op_rate(x, name, passes)
                ref = probe_kernels.op_plain(x, name, passes)
                err, limit, ok = probes.compare(out, ref, rule)
                assert ok, (rows, rule, passes, err, limit)
            assert torch.equal(out, probe_kernels.op_rate(x, name, passes)), rows
    layout = probe_kernels.op_layout(name, 20001)
    assert layout["grid"] * layout["warps"] * layout["rows_per_warp"] < 20001


def test_probe_op_layout_fills_every_sm_once(gen):
    """At the probe's 9216 rows every SM holds the same CTAs (the grid is
    their cap times the SMs, at most one short) and the row slots cover the
    rows in one round, within one slot a warp of the SM's share."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in probe_kernels.OPS:
        lay = probe_kernels.op_layout(name, 9216)
        slots = lay["ctas_per_sm"] * lay["warps"] * lay["rows_per_warp"]
        assert lay["grid"] > (lay["ctas_per_sm"] - 1) * sms, lay
        assert 9216 / sms <= slots < 9216 / sms + lay["rows_per_warp"] * lay["ctas_per_sm"], lay


def test_probe_op_sass_matches_mix(gen):
    """The SASS check: cuobjdump's SASS of each probe_op_kernel<OP>'s main
    pass loop, over its unroll and rows a warp, issues no fewer instructions
    than window_cost.OP_MIX on any unit, and takes no longer on any unit
    than the mix on its binding unit (on the issue slot up to SLOT_SLACK
    longer, the loop's control)."""
    from sam3_lora_tpu_torch.ops import _cuda
    from sam3_lora_tpu_torch.probes import window_cost

    sass = window_cost.op_sass(_cuda.build())
    bad = {name: window_cost.sass_check(name, sass[name]) for name in probe_kernels.OPS}
    assert not any(bad.values()), (bad, sass)


def test_probe_pair_backward_matches_plain(gen):
    """The packed layout's backward (the attention backward kernel on the
    pair view) against the JAX-rounded plain version, per gradient."""
    q, k, v, do = (probes.pair_view(torch.randn(8, 576, 128, generator=gen, device="cuda")
                                    .to(torch.bfloat16)) for _ in range(4))
    o, lse = attention_kernel.attention_cuda(q, k, v, 0.125, with_lse=True)
    grads = probe_kernels.pair_bwd(q, k, v, o, lse, do, 0.125)
    for a, b in zip(grads, probe_kernels.pair_bwd_plain(q, k, v, do, 0.125)):
        err, limit, ok = probes.compare(a, b, "bwd")
        assert ok, (err, limit)


def test_probe_wrappers_count_and_check(gen):
    probe_kernels.reset_counts()
    q, k, v = _heads(gen, 4, 2, 576)
    probe_kernels.stage(q, k, v, "qk_pv", 0.125, pair=True, wpc=2)
    probe_kernels.op_rate(torch.ones(576, 576, device="cuda"), "add_f32", 1)
    assert probe_kernels.stage.launches == {"qk_pv_pair_wpc2": 1}
    assert probe_kernels.op_rate.launches == {"add_f32": 1}
    with pytest.raises(ValueError, match="wpc"):
        probe_kernels.stage(q, k, v, "full", 0.125, wpc=3)
    with pytest.raises(ValueError, match="pair"):
        probe_kernels.stage(q, k, v, "qk_exp_pv", 0.125, pair=True)
    with pytest.raises(ValueError, match="head_dim"):
        probe_kernels.stage(*(t[..., :32] for t in (q, k, v)), "full", 0.125)


def _nms_candidates(n: int = 200, side: int = 288):
    """``n`` seeded box masks at ``side``² and scores in steps of 1/16, so
    that many tie: the serving path's candidate count and mask size."""
    rng = np.random.RandomState(0)
    masks = np.zeros((n, side, side), bool)
    for i in range(n):
        x0, y0 = rng.randint(0, side - 40, 2)
        w, h = rng.randint(20, 120, 2)
        masks[i, y0:y0 + h, x0:x0 + w] = True
    scores = rng.randint(0, 16, n).astype(np.float32) / 16
    return torch.from_numpy(masks), torch.from_numpy(scores)


def test_mask_iou_on_the_card_equals_the_cpu(gen):
    """mask_iou at 200 x 288² on the card, bit for bit the CPU's: the 0/1
    product sums exactly, and the division rounds once on both."""
    from sam3_lora_tpu_torch.ops.masks import mask_iou, masks_to_boxes

    masks, _ = _nms_candidates()
    want = mask_iou(masks, masks)
    assert torch.equal(mask_iou(masks.cuda(), masks.cuda()).cpu(), want)
    assert torch.equal(masks_to_boxes(masks.cuda()).cpu(), masks_to_boxes(masks))


@pytest.mark.parametrize("impl", ["nms_masks", "device_loop"])
def test_nms_on_the_card_equals_the_cpu(gen, impl):
    """The NMS keep mask at N = 200 with tied scores and a valid mask on the
    card, bit for bit the CPU's: ``nms_masks`` (IoU on the card, the loop on
    the host) and chip_smoke's device loop, the design it was measured
    against."""
    from sam3_lora_tpu_torch.ops.masks import mask_iou
    from sam3_lora_tpu_torch.ops.nms import nms_masks

    masks, scores = _nms_candidates()
    valid = torch.from_numpy(np.random.RandomState(1).rand(200) > 0.1)
    m, s, iou = masks.cuda(), scores.cuda(), mask_iou(masks.cuda(), masks.cuda())
    for thr in (0.3, 0.7):
        for v in (None, valid):
            want = nms_masks(masks, scores, thr, valid=v)
            vc = None if v is None else v.cuda()
            got = (nms_masks(m, s, thr, valid=vc) if impl == "nms_masks"
                   else chip_smoke.nms_device_loop(iou, s, thr, valid=vc))
            assert got.is_cuda and torch.equal(got.cpu(), want), (thr, v is None)


def test_sam_heads_on_the_card_match_the_cpu(gen):
    """The interactive predictor's SAM heads at the full width (d 256 over
    the 72x72 grid, high-res maps at 288 and 144), bf16 on the card, against
    the same heads in fp32 on the CPU on the same features: multimask logits
    and IoU within chip_smoke.SMALL_TOL * max |cpu|."""
    from sam3_lora_tpu_torch.config import ModelConfig
    from sam3_lora_tpu_torch.models import init_model
    from sam3_lora_tpu_torch.predictor import SAM3InteractiveImagePredictor, tracker_core

    cfg = ModelConfig(dtype="bfloat16")
    pred = SAM3InteractiveImagePredictor.__new__(SAM3InteractiveImagePredictor)
    pred.cfg, pred.device = cfg, torch.device("cuda")
    pred.core = init_model(tracker_core(cfg, pred.device), gen).eval()
    d, f = cfg.d_model, cfg.feat_size
    pred._features = {k: torch.randn(1, d, s, s, generator=gen, device="cuda").to(torch.bfloat16)
                      for k, s in (("vis", f), ("hi0", 4 * f), ("hi1", 2 * f))}
    pred._orig_size = (900, 1200)
    worst = chip_smoke.heads_against_cpu(pred, (chip_smoke.CLICK, chip_smoke.BOX_CLICK))
    assert worst <= chip_smoke.SMALL_TOL, worst


def test_dense_rpb_oracle_matches_separable_route_at_full_width(gen):
    """The decoder's dense boxRPB oracle against the separable route at the
    full width (200 queries, 6 layers, 72x72 keys), bf16, within
    chip_smoke.SMALL_TOL; a box_rpb="none" decoder finite."""
    from sam3_lora_tpu_torch.config import ModelConfig

    worst, finite = chip_smoke.decoder_options(ModelConfig(dtype="bfloat16"), "cuda", gen)
    assert worst <= chip_smoke.SMALL_TOL and finite, (worst, finite)


def _assignment_problems(b: int = 16, t: int = 16, q: int = 200):
    """1 - mask IoU problems as the association builds them: tracks as
    rows, ``q`` detections as columns, some of them copies (IoU ties)."""
    from sam3_lora_tpu_torch.ops.masks import mask_iou

    masks, _ = _nms_candidates(q, 96)
    rng = np.random.RandomState(2)
    cost = []
    for _ in range(b):
        trk = masks[torch.from_numpy(rng.randint(0, q, t))]
        cost.append(1.0 - mask_iou(trk, masks))
    return torch.stack(cost), torch.from_numpy(rng.rand(b, t) > 0.2)


def test_auction_on_the_card_equals_the_cpu(gen):
    """The auction over 16 problems of 16 tracks x 200 detections on the
    card, bit for bit the CPU's (the same fp32 bids and the same first
    index among ties); and at the cap (a price war that never settles)."""
    from sam3_lora_tpu_torch.train.matcher import auction

    cost, valid = _assignment_problems()
    assert torch.equal(auction(cost.cuda(), valid.cuda()).cpu(), auction(cost, valid))
    war = torch.tensor([[[0.1, 0.2], [0.3, 0.1], [0.2, 0.2]]])
    for cap in (1023, 1024):
        assert torch.equal(auction(war.cuda(), max_iters=cap).cpu(), auction(war, max_iters=cap))


def test_batched_components_on_the_card_equal_the_cpu(gen):
    """connected_components, component sizes and the hole filling over 16
    masks at 288² on the card, bit for bit the CPU's (integer labels;
    the filled logits are the inputs or +-0.1)."""
    from sam3_lora_tpu_torch.ops.cc import component_sizes, connected_components
    from sam3_lora_tpu_torch.video import fill_holes_in_mask_scores

    logits = torch.randn(16, 288, 288, generator=gen, device="cuda")
    logits = torch.nn.functional.avg_pool2d(logits[:, None], 9, 1, 4)[:, 0]  # blobs
    for m in (logits > 0, logits <= 0):
        lab = connected_components(m)
        assert torch.equal(lab.cpu(), connected_components(m.cpu()))
        assert torch.equal(component_sizes(lab).cpu(), component_sizes(lab.cpu()))
    assert torch.equal(fill_holes_in_mask_scores(logits, 16).cpu(),
                       fill_holes_in_mask_scores(logits.cpu(), 16))


def test_tracker_stages_on_the_card_match_the_cpu(gen):
    """make_tracker_fns' propagate and update_memory at the full width (d
    256, memory 64 over the 72x72 grid, 7 memory frames, 16 pointers, high
    resolution maps at 288 and 144), bf16 on the card against fp32 on the
    CPU, on two slots of a seeded state (a full ring; cond and pointers
    only): within chip_smoke.SMALL_TOL * max |cpu|, ages equal."""
    from sam3_lora_tpu_torch.config import ModelConfig
    from sam3_lora_tpu_torch.video import init_track_state, video_tracker_core

    cfg = ModelConfig(dtype="bfloat16")
    core = video_tracker_core(cfg, torch.device("cuda"), 7, 16)
    d, f = cfg.d_model, cfg.feat_size
    st = init_track_state(2, (288, 288), 7, 16, 64, d, (f, f), device="cuda")
    st = st._replace(
        alive=torch.ones(2, dtype=torch.bool, device="cuda"),
        obj_ids=torch.tensor([0, 1], dtype=torch.int32, device="cuda"),
        masks=torch.randn(2, 288, 288, generator=gen, device="cuda"),
        maskmem=torch.randn(2, 7, 64, f, f, generator=gen, device="cuda"),
        obj_ptrs=torch.randn(2, 16, d, generator=gen, device="cuda"),
        maskmem_age=torch.tensor([[9, 0, 1, 2, 3, 4, 5], [2, -1, -1, -1, -1, -1, -1]],
                                 dtype=torch.int32, device="cuda"),
        obj_ptr_age=torch.tensor([list(range(16)), [0, 1] + [-1] * 14], dtype=torch.int32,
                                 device="cuda"))
    feats = [torch.randn(1, d, s, s, generator=gen, device="cuda").to(torch.bfloat16)
             for s in (4 * f, 2 * f, f)]
    poss = [torch.randn(1, d, s, s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in (4 * f, 2 * f, f)]
    res = chip_smoke.tracker_against_cpu(core, st, feats, poss,
                                         torch.arange(2, device="cuda"))
    worst = {k: v for k, v in res.items() if isinstance(v, float)}
    assert all(v <= chip_smoke.SMALL_TOL for v in worst.values()), res
    assert res["ages_equal"] and all(m <= chip_smoke.SMALL_TOL for _, m in res["index_flips"])


def test_gloo_collectives_over_cuda_tensors(gen, tmp_path):
    """Two ranks on the one card under gloo: the trainer's bucketed mean and
    broadcast, and the frame-parallel all-gather, on CUDA tensors
    (``tests/torch_dist_worker.py cuda``)."""
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_dist_worker.py"), str(tmp_path), "cuda"],
        env={**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": "0", "PYTHONPATH": root},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK rank={r}" in out, out


def test_frame_parallel_detector_on_the_card(gen):
    """World size 1: a chunk of 4 frames as one batch through _forward on
    the card (side-stream copies from pinned memory; the small bf16 config
    of chip_smoke, whose attention runs the kernels) within
    chip_smoke.SMALL_TOL of each frame alone."""
    from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
    from sam3_lora_tpu_torch.inference import SAM3LoRAInference
    from sam3_lora_tpu_torch.parallel import FrameParallelDetector

    cfg = tiny_model_config(flash_attention_min_seq=16, vit_dim=128, vit_heads=2, d_model=128,
                            enc_heads=4, dtype="bfloat16")
    eng = SAM3LoRAInference(cfg, LoRAConfig(target_modules=("qkv",)), device="cuda")
    rng = np.random.RandomState(0)
    frames = [eng.preprocess(rng.randint(0, 256, (40, 60, 3)).astype(np.uint8))[0][0]
              for _ in range(6)]
    ids = np.asarray(eng.tokenizer(["crack"], context_length=eng.cfg.text_context_length),
                     np.int64)[0]
    outs = list(FrameParallelDetector(SAM3LoRAInference._forward, eng, chunk_size=4)
                .detect_video(frames, ids))
    assert len(outs) == 6
    for frame, out in zip(frames, outs):
        alone = eng._forward(torch.from_numpy(frame[None]).cuda(), torch.from_numpy(ids[None]).cuda())
        for got, want in zip(out, alone):
            assert np.abs(got - want[0].cpu().numpy()).max() <= chip_smoke.SMALL_TOL
