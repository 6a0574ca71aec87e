"""Int8 GEMMs for the frozen base (port of ``sam3_lora_tpu/ops/quant.py``).

The LoRA recipe freezes every base weight, so quantizing it is exact with
respect to what is learned: the adapters train against the quantized base,
y = q(W)x + (alpha/r)BAx, with no train/serve mismatch. Scheme: symmetric
per-output-channel weight scales and dynamic symmetric per-row activation
scales (W8A8):

    s_x[m]  = max(max_k |x[m, k]| / 127, 1e-12)   (per token row)
    s_w[n]  = max(max_k |W[n, k]| / 127, 1e-12)   (per output channel)
    y[m, n] = (int8(x/s_x) . int8(W/s_w))[m, n] * s_x[m] * s_w[n]

The port's weight is (N, K), (out, in); ``quantize_weight`` gives (N, K) int8
and an (N,) fp32 scale (the JAX package's (K, N) and (1, N), transposed).
The forward product is ``gemm_int8.int8_gemm_wres`` (K4) or, with the fused
adapters, ``int8_lora_gemm_wres`` (K5).

Gradients (``torch.autograd.Function``s matching the JAX ``custom_vjp``s):
dx = dy . dequant(W), taken against the dequantized weight the forward used,
so adapter gradients are exact for the quantized forward. The frozen weight
and its scale get no gradient. dx goes to K6 (``bf16_gemm_wres_nt``) when
``GEMM_BWD_KERNEL`` is on and the shape passes ``supported_nt``; otherwise it
is a plain product against the dequantized weight. The fused adapter
Function's backward adds the skinny adapter products in the compute dtype
with fp32 accumulation (``_int8_lora_bwd``).

Products that JAX runs with an fp32 result (``preferred_element_type``) run
here in fp32 on the CPU; on the card they are cuBLAS products of the
compute-dtype operands, which accumulate in fp32 and round the result to the
compute dtype once more.

``base_quant="int8_bwd"`` (dx also int8) is not ported: ``models/builder.py``
raises on it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import gemm_int8
from .gemm_int8 import dequantize, quant_rows


def quantize_weight(w: torch.Tensor):
    """(N, K) weight -> (int8 (N, K), fp32 per-output-channel scale (N,))."""
    q, s = quant_rows(w)
    return q, s[:, 0]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands with an fp32 result (see the module
    docstring for the card)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return (a @ b).float()


def _apply(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    y = gemm_int8.int8_gemm_wres(x.reshape(-1, x.shape[-1]), wq, ws)
    return y.reshape(*lead, wq.shape[0])


def _dx(dy: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """dy (..., N) . dequant(wq, ws) -> (..., K) in dy's dtype."""
    n, k = wq.shape
    dy2 = dy.reshape(-1, n)
    if gemm_int8.GEMM_BWD_KERNEL and gemm_int8.supported_nt(dy2.shape[0], k, n):
        dx = gemm_int8.bf16_gemm_wres_nt(dy2, wq, ws)
    else:
        dx = _mm(dy2, dequantize(wq, ws, dy.dtype)).to(dy.dtype)
    return dx.reshape(*dy.shape[:-1], k)


class _Int8Matmul(torch.autograd.Function):
    """y = x . W^T with W quantized per call (``int8_matmul``)."""

    @staticmethod
    def forward(ctx, x, w):
        wq, ws = quantize_weight(w.detach())
        ctx.save_for_backward(wq, ws)
        return _apply(x, wq, ws)

    @staticmethod
    def backward(ctx, dy):
        wq, ws = ctx.saved_tensors
        return _dx(dy, wq, ws), None


class _Int8MatmulPrequant(torch.autograd.Function):
    """y = x . dequant(wq, ws)^T with the weight quantized offline."""

    @staticmethod
    def forward(ctx, x, wq, ws):
        ctx.save_for_backward(wq, ws)
        return _apply(x, wq, ws)

    @staticmethod
    def backward(ctx, dy):
        wq, ws = ctx.saved_tensors
        return _dx(dy, wq, ws), None, None


class _Int8LoRAMatmulPrequant(torch.autograd.Function):
    """y = x . dequant(wq, ws)^T + scale * (x la^T) lb^T in one product."""

    @staticmethod
    def forward(ctx, x, wq, ws, la, lb, scale):
        dt = x.dtype
        lead = x.shape[:-1]
        y = gemm_int8.int8_lora_gemm_wres(x.reshape(-1, x.shape[-1]), wq, ws,
                                          la.detach().to(dt), lb.detach().to(dt), scale)
        ctx.save_for_backward(x, wq, ws, la, lb)
        ctx.scale = scale
        return y.reshape(*lead, wq.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, wq, ws, la, lb = ctx.saved_tensors
        scale = ctx.scale
        dt = dy.dtype
        n, k = wq.shape
        dyf = dy.reshape(-1, n)
        xf = x.reshape(-1, k).to(dt)
        la_c, lb_c = la.detach().to(dt), lb.detach().to(dt)
        dyb = _mm(dyf, lb_c)                                       # (M, r) = dy lb
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _mm(dyf, dequantize(wq, ws, dt)) + scale * _mm(dyb.to(dt), la_c)
            dx = dx.to(dt).reshape(x.shape)
        da = scale * _mm(dyb.to(dt).T, xf)                         # (r, K) = (dy lb)^T x
        xa = _mm(xf, la_c.T).to(dt)                                # (M, r) = x la^T
        db = scale * _mm(dyf.T, xa)                                # (N, r) = dy^T (x la^T)
        return dx, None, None, da, db, None


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) . w (N, K)^T with dynamic W8A8 quantization (the weight is
    quantized on every call); returns (..., N) in x's dtype."""
    return _Int8Matmul.apply(x, w)


def int8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x (..., K) . dequant(wq (N, K) int8, ws (N,) fp32)^T; numerically
    identical to ``int8_matmul`` of the weight ``quantize_weight`` took."""
    return _Int8MatmulPrequant.apply(x, wq, ws)


def int8_lora_matmul_prequant(x, wq, ws, la, lb, scale: float) -> torch.Tensor:
    """``int8_matmul_prequant`` plus the adapter branch scale * (x la^T) lb^T,
    fused into one product (K5 on the card); la (r, K) and lb (N, r) are
    the fp32 adapters, used in x's dtype. Returns (..., N) in x's dtype."""
    return _Int8LoRAMatmulPrequant.apply(x, wq, ws, la, lb, float(scale))


def prequantize_model(model: nn.Module, min_dim: int = 512) -> int:
    """Quantize every eligible frozen ``LoRALinear`` weight once, in place
    (``prequantize_base``/``prequantize_tree`` of the JAX package): a layer
    with a ``weight_scale`` (the config's quant gate covers it), a float 2-D
    weight and ``min(N, K) >= min_dim`` gets an int8 ``weight`` parameter and
    its scale. Adapters are untouched. Returns the number quantized."""
    from ..models.layers import LoRALinear

    n = 0
    for m in model.modules():
        if not isinstance(m, LoRALinear) or m.weight_scale is None:
            continue
        w = m.weight
        if w.dim() != 2 or min(w.shape) < min_dim or w.dtype == torch.int8:
            continue
        wq, ws = quantize_weight(w.detach())
        m.weight = nn.Parameter(wq, requires_grad=False)
        with torch.no_grad():
            m.weight_scale.copy_(ws)
        n += 1
    return n
