"""The int8 tier's GEMM kernels (K4, K5, K6 in ``csrc/gemm_int8.cu``): their
wrappers, launch counters and plain PyTorch versions, and the routing flags
of the JAX package's ``ops/gemm_int8.py``.

* ``int8_gemm_wres`` (K4): y = (int8(x / s_x) . W_q^T) * s_x * s_w, with the
  per-row dynamic activation scale s_x = max(amax_row / 127, 1e-12).
* ``int8_lora_gemm_wres`` (K5): K4 + scale * ((x A^T) B^T), the adapter
  products in the compute dtype with fp32 accumulation.
* ``bf16_gemm_wres_nt`` (K6): dx = dy . dequant(W_q, s_w), fp32 accumulation.

The port's weight is W_q (N, K) int8, (out, in) as in ``nn.Linear``, with a
per-output-channel fp32 scale s_w (N,); the adapters are ``lora_a`` (r, K)
and ``lora_b`` (N, r). Each wrapper routes by the device of its operands: the
plain version for CPU tensors, the kernel for CUDA tensors (counted on
``wrapper.launches``), an error for anything else. The kernel wrapper checks
what the kernel takes and raises otherwise; there is no fallback.

The plain versions follow ``sam3_lora_tpu/ops/quant.py``'s XLA expressions:
the quantization divides (``t / s``) and rounds half to even, the int8 sum is
computed exactly (float64 holds every partial sum below 2**53) and cast to
fp32, then scaled row then column. They serve the CPU path and the kernel
checks of ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Routing flags, read from the same environment variables as the JAX package,
with the same defaults (off):

* ``GEMM_LORA_FUSED`` (``SAM3_GEMM_LORA_FUSED=1``): adapted int8 layers take
  K5 in place of K4 plus the unfused adapter branch (``models/layers.py``).
* ``GEMM_BWD_KERNEL`` (``SAM3_GEMM_BWD_KERNEL=1``): the backward's dx goes to
  K6 for the shapes ``supported_nt`` admits; otherwise it is a plain
  ``torch.matmul`` against the dequantized weight, as the JAX package leaves
  it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import _cuda

GEMM_LORA_FUSED = os.environ.get("SAM3_GEMM_LORA_FUSED", "0") == "1"
GEMM_BWD_KERNEL = os.environ.get("SAM3_GEMM_BWD_KERNEL", "0") == "1"
K_ALIGN = 32    # the kernels' contraction step
MAX_RANK = 64   # K5's largest adapter rank


def supported_nt(m: int, k: int, n: int) -> bool:
    """Which dx products go to K6 when ``GEMM_BWD_KERNEL`` is on: the width
    gate of the JAX package's ``supported_nt`` (the wide MLP GEMMs)."""
    return max(k, n) >= 4096


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sam3_int8_gemm.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.sam3_int8_gemm.restype = i32
    lib.sam3_int8_lora_gemm.argtypes = [ptr] * 6 + [i32] * 4 + [ctypes.c_float, ptr]
    lib.sam3_int8_lora_gemm.restype = i32
    lib.sam3_bf16_gemm_nt.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.sam3_bf16_gemm_nt.restype = i32
    return lib


# --------------------------------------------------------------- plain versions


def quant_rows(t: torch.Tensor):
    """Symmetric int8 quantization along the last dim (``quant.py::
    _quant_lastdim``): -> (q int8, s fp32 with keepdim). Zero rows get
    s = 1e-12 and quantize to zeros."""
    t = t.float()
    amax = t.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the division the kernel rounds
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(t / s), -127.0, 127.0).to(torch.int8)
    return q, s


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) . int8 (N, K)^T -> the exact sums, cast to fp32."""
    return (xq.double() @ wq.double().T).float()


def dequantize(wq: torch.Tensor, ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, K) int8, (N,) fp32 -> (N, K) in ``dtype``: fp32 product, one rounding."""
    return (wq.float() * ws[:, None]).to(dtype)


def int8_gemm_wres_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """K4's plain version: (M, K) x -> (M, N) in x's dtype."""
    xq, xs = quant_rows(x)
    return (int8_dot(xq, wq) * xs * ws).to(x.dtype)


def int8_lora_gemm_wres_plain(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """K5's plain version: K4's output rounded to x's dtype, plus
    scale * ((x a^T) b^T) with a (r, K), b (N, r) in x's dtype, each product
    accumulated in fp32, xa rounded to x's dtype between them."""
    y = int8_gemm_wres_plain(x, wq, ws)
    xa = (x.float() @ a.float().T).to(x.dtype)
    delta = xa.float() @ b.float().T
    return (y.float() + delta * scale).to(x.dtype)


def bf16_gemm_wres_nt_plain(dy: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """K6's plain version: (M, N) dy . dequant(wq, ws) (N, K) -> (M, K) in
    dy's dtype, fp32 accumulation."""
    return (dy.float() @ dequantize(wq, ws, dy.dtype).float()).to(dy.dtype)


# ---------------------------------------------------------------- kernel wrappers


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_k(k: int) -> None:
    if k % K_ALIGN:
        raise ValueError(f"the int8 GEMM kernels need K % {K_ALIGN} == 0, got K = {k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def int8_gemm_wres_cuda(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch K4 on (M, K) bf16 x, (N, K) int8 wq, (N,) fp32 ws."""
    m, k = x.shape
    n = wq.shape[0]
    _check_k(k)
    _check("x", x, torch.bfloat16, (m, k))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        _raise_on(_library().sam3_int8_gemm(x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                            out.data_ptr(), m, n, k, _stream(x)),
                  "sam3_int8_gemm")
    return out


def int8_lora_gemm_wres_cuda(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """Launch K5: K4's operands plus a (r, K) and b (N, r) bf16."""
    m, k = x.shape
    n, r = wq.shape[0], a.shape[0]
    _check_k(k)
    if r % 8 or r > MAX_RANK:
        raise ValueError(f"K5 needs rank % 8 == 0 and rank <= {MAX_RANK}, got {r}")
    _check("x", x, torch.bfloat16, (m, k))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    _check("lora_a", a, torch.bfloat16, (r, k))
    _check("lora_b", b, torch.bfloat16, (n, r))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        _raise_on(_library().sam3_int8_lora_gemm(
            x.data_ptr(), wq.data_ptr(), ws.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, n, k, r, float(scale), _stream(x)), "sam3_int8_lora_gemm")
    return out


def bf16_gemm_wres_nt_cuda(dy: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch K6 on (M, N) bf16 dy, (N, K) int8 wq, (N,) fp32 ws -> (M, K)."""
    m, n = dy.shape
    k = wq.shape[1]
    _check_k(k)
    if n % K_ALIGN:
        raise ValueError(f"K6 needs N % {K_ALIGN} == 0, got N = {n}")
    _check("dy", dy, torch.bfloat16, (m, n))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    if m:
        _raise_on(_library().sam3_bf16_gemm_nt(dy.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                               out.data_ptr(), m, n, k, _stream(dy)),
                  "sam3_bf16_gemm_nt")
    return out


def _on_cpu(fn, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if not t.is_cuda:
        raise ValueError(f"{fn.__name__}: no kernel for device {t.device}")
    return False


def int8_gemm_wres(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """(M, K) x . dequant(wq (N, K), ws (N,))^T -> (M, N): K4 on the card,
    the plain version on the CPU."""
    if _on_cpu(int8_gemm_wres, x):
        return int8_gemm_wres_plain(x, wq, ws)
    out = int8_gemm_wres_cuda(x.contiguous(), wq, ws)
    int8_gemm_wres.launches += 1
    return out


def int8_lora_gemm_wres(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """K4 plus the fused adapter branch scale * ((x a^T) b^T), a (r, K) and
    b (N, r) in x's dtype: K5 on the card, the plain version on the CPU."""
    if _on_cpu(int8_lora_gemm_wres, x):
        return int8_lora_gemm_wres_plain(x, wq, ws, a, b, scale)
    out = int8_lora_gemm_wres_cuda(x.contiguous(), wq, ws, a.contiguous(), b.contiguous(), scale)
    int8_lora_gemm_wres.launches += 1
    return out


def bf16_gemm_wres_nt(dy: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """(M, N) dy . dequant(wq, ws) -> (M, K): K6 on the card, the plain
    version on the CPU."""
    if _on_cpu(bf16_gemm_wres_nt, dy):
        return bf16_gemm_wres_nt_plain(dy, wq, ws)
    out = bf16_gemm_wres_nt_cuda(dy.contiguous(), wq, ws)
    bf16_gemm_wres_nt.launches += 1
    return out


int8_gemm_wres.launches = 0
int8_lora_gemm_wres.launches = 0
bf16_gemm_wres_nt.launches = 0
