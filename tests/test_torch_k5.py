"""K5, the int8 GEMM with the fused LoRA branch (``ops/gemm_int8.py::
int8_lora_gemm_wres``), as the card computes it, on the CPU.

The kernel (``csrc/gemm_int8.cu``, ``csrc/gemm_sm90.cuh``) takes two
launches: one pass over x (K4's row quantization, and xa), then K4's
mainloop with a low-rank step at the end of each tile. Its order of operations, written out
here as ``kernel_order``:

    xq, s_x = quant_rows(x)                           (K4's bits, first pass)
    xa'     = bf16(fp32(scale * (x . a^T)))           (first pass: scale folded in)
    y       = fp32(bf16(fp32(xq . wq^T) * s_x * s_w)) (K4's output, widened)
    out     = bf16(y + fp32(xa' . b^T))               (the low-rank step, one rounding)

Tolerances. For a power of two scale, bf16(scale * v) = scale * bf16(v) and
the fp32 products and sums scale exactly, so ``kernel_order`` equals the
plain version (xa rounded unscaled, the delta scaled after) bit for bit.
For any other scale xa' carries one more bf16 rounding: within GEMM_RTOL =
8e-3 of max |plain| (one bf16 ulp of the largest output, the bound
``chip_smoke.py`` holds the card to). Against the JAX Pallas kernel (interpret
mode), which scales s = amax * (1/127) rather than dividing and rounds only
once at the end, the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.ops import gemm_int8 as jgemm
from sam3_lora_tpu.ops import quant as jquant
from sam3_lora_tpu_torch.ops import gemm_int8, quant

GEMM_RTOL = 8e-3
RANKS = [8, 24, 64]
SCALES = [0.5, 1.5, 2.0]


def kernel_order(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """K5's order of operations on the card, in plain PyTorch (bf16 x)."""
    xq, sx = gemm_int8.quant_rows(x)
    xa = (scale * (x.float() @ a.float().T)).to(torch.bfloat16)
    y = (gemm_int8.int8_dot(xq, wq) * sx * ws).to(torch.bfloat16).float()
    return (y + xa.float() @ b.float().T).to(torch.bfloat16)


def _operands(seed: int, m: int, k: int, n: int, r: int):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5).astype(np.float32))
    wq, ws = quant.quantize_weight(w)
    a = torch.from_numpy((0.1 * rng.standard_normal((r, k))).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((0.1 * rng.standard_normal((n, r))).astype(np.float32)).to(torch.bfloat16)
    return x, wq, ws, a, b


def _assert_within(got, ref) -> None:
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= GEMM_RTOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("r", RANKS)
def test_kernel_order_matches_plain(r, scale):
    """At a ragged M (37 rows: a partial 128-row tile) and small widths."""
    x, wq, ws, a, b = _operands(r, 37, 96, 136, r)
    got = kernel_order(x, wq, ws, a, b, scale)
    ref = gemm_int8.int8_lora_gemm_wres_plain(x, wq, ws, a, b, scale)
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == (37, 136)
    if scale in (0.5, 2.0):
        assert torch.equal(got, ref)
    else:
        _assert_within(got, ref)
    # the CPU route of the wrapper is the plain version
    assert torch.equal(gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, scale), ref)


@pytest.mark.parametrize("r", RANKS)
def test_kernel_order_y_is_k4(r):
    """The low-rank step adds onto K4's output: with b = 0 the kernel's order
    gives K4's plain output bit for bit."""
    x, wq, ws, a, b = _operands(1, 21, 64, 48, r)
    got = kernel_order(x, wq, ws, a, torch.zeros_like(b), 1.5)
    assert torch.equal(got, gemm_int8.int8_gemm_wres_plain(x, wq, ws))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgemm, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jgemm, "GEMM_KERNEL", True)


@pytest.mark.parametrize("scale", [1.5, 2.0])
@pytest.mark.parametrize("r", RANKS)
def test_kernel_order_matches_jax_pallas_kernel(interpret, r, scale):
    """The JAX Pallas K5 in bf16 (interpret mode) on the same numpy inputs."""
    m, k, n = 64, 128, 264
    x, wq, ws, a, b = _operands(10 + r, m, k, n, r)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jwq, jws = jnp.asarray(wq.numpy().T), jnp.asarray(ws.numpy()[None, :])
    ja = jnp.asarray(a.float().numpy().T, jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy().T, jnp.bfloat16)
    ref = jgemm.int8_lora_gemm_wres(jx, jwq, jws, ja, jb, scale)
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    _assert_within(kernel_order(x, wq, ws, a, b, scale), ref)


def test_quantized_weight_layout_matches_jax():
    """The (N, K) int8 weight and (N,) scale the port hands K5 are the JAX
    package's (K, N) and (1, N) ones transposed."""
    w = np.random.RandomState(3).standard_normal((64, 40)).astype(np.float32)
    jwq, jws = jquant.quantize_weight(jnp.asarray(w.T))
    wq, ws = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws)[0])


@pytest.mark.parametrize("m,k,n,r,match", [
    (64, 1024, 4736, 4, "rank"),      # under the 16-byte row of xa and lora_b
    (64, 1024, 4736, 12, "rank"),
    (64, 1024, 4736, 0, "rank"),
    (64, 1024, 4736, 72, "rank"),     # over one 64-column box
    (64, 1008, 4736, 8, "K % 32"),
    (64, 1024, 4740, 8, "N % 8"),     # the TMA-stored output rows
    (-1, 1024, 4736, 8, "M >= 0"),
])
def test_k5_shape_check_refuses(m, k, n, r, match):
    with pytest.raises(ValueError, match=match):
        gemm_int8.check_lora_shape(m, k, n, r)


def test_k5_shape_check_admits_the_main_path_shapes():
    """Every adapted int8 GEMM of chip_smoke's main paths (qkv, fc1, fc2 and
    the text GEMMs at serving, training, bench.py's batch and a ragged M) at
    every rank class."""
    import chip_smoke

    for _, _, m, k, n in chip_smoke.gemm_cases():
        for r in (8, 16, 24, 32, 40, 48, 56, 64):
            gemm_int8.check_lora_shape(m, k, n, r)


@pytest.mark.parametrize("m,k,r", [(1, 32, 8), (37, 96, 24), (5184, 1024, 8), (1000, 4736, 64)])
def test_k5_scratch_layout(m, k, r):
    """xq, s_x and xa share one buffer without overlap, each aligned for its
    reader (xa's 16-byte rows for TMA)."""
    sx_at, xa_at, nbytes = gemm_int8.k5_scratch_layout(m, k, r)
    assert sx_at == m * k and sx_at % 16 == 0
    assert xa_at >= sx_at + 4 * m and xa_at % 16 == 0 and xa_at - (sx_at + 4 * m) < 16
    assert nbytes == xa_at + 2 * m * r


def test_k5_wrapper_checks_raise_without_cuda():
    """On a CPU host the kernel wrapper refuses a bad rank (before any
    library load) and a CPU tensor; the routed entry takes the plain
    version for CPU tensors and raises for other devices."""
    x, wq, ws, a, b = _operands(0, 16, 64, 64, 8)
    with pytest.raises(ValueError, match="rank"):
        gemm_int8.int8_lora_gemm_wres_cuda(x, wq, ws, a[:4].contiguous(), b[:, :4].contiguous(), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gemm_int8.int8_lora_gemm_wres_cuda(x, wq, ws, a, b, 1.0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gemm_int8.int8_lora_gemm_wres(x.to("meta"), wq, ws, a, b, 1.0)
    before = gemm_int8.int8_lora_gemm_wres.launches
    gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 1.0)
    assert gemm_int8.int8_lora_gemm_wres.launches == before
