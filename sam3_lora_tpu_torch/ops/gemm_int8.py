"""The int8 tier's GEMM kernels (K4, K5, K6 in ``csrc/gemm_int8.cu``): their
wrappers, launch counters and plain PyTorch versions, and the routing flags
of the JAX package's ``ops/gemm_int8.py``.

* ``int8_gemm_wres`` (K4): y = (int8(x / s_x) . W_q^T) * s_x * s_w, with the
  per-row dynamic activation scale s_x = max(amax_row / 127, 1e-12). On the
  card, two launches: the row quantization (``quant_rows``) and the s8
  mainloop of ``csrc/gemm_sm90.cuh`` (``int8_dot``, then the row and column
  scales).
* ``int8_lora_gemm_wres`` (K5): K4 + scale * ((x A^T) B^T), the adapter
  products in the compute dtype with fp32 accumulation. On the card, two
  launches: one pass over x writes K4's row quantization and xa =
  bf16(scale * x A^T) (M, r), then the s8 mainloop with a low-rank step at
  the end of each tile (y, K4's bf16 output widened to fp32, plus xa B^T on
  the tensor cores).
* ``bf16_gemm_wres_nt`` (K6): dx = dy . dequant(W_q, s_w), fp32 accumulation.
  On the card, two launches: ``dequantize_t`` (W_deq^T, (K, N) bf16) and the
  bf16 mainloop of ``csrc/gemm_sm90.cuh``.

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
MAX_K = 133143  # K * 127**2 < 2**31: K4's int32 sums cannot overflow


def supported_nt(m: int, k: int, n: int) -> bool:
    """Which dx products go to K6 when ``GEMM_BWD_KERNEL`` is on: the width
    gate of the JAX package's ``supported_nt`` (the wide MLP GEMMs)."""
    return max(k, n) >= 4096


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.sam3_quant_rows, [ptr] * 3 + [i32] * 2 + [ptr]),
                     (lib.sam3_int8_gemm, [ptr] * 6 + [i32] * 3 + [ptr]),
                     (lib.sam3_int8_lora_gemm, [ptr] * 9 + [i32] * 4 + [ctypes.c_float, ptr]),
                     (lib.sam3_dequant_t, [ptr] * 3 + [i32] * 2 + [ptr]),
                     (lib.sam3_bf16_gemm_nt, [ptr] * 5 + [i32] * 3 + [ptr])):
        fn.argtypes, fn.restype = args, i32
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


def dequantize_t(wq: torch.Tensor, ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``dequantize`` transposed, contiguous: (K, N) in ``dtype``, the JAX
    package's (K, N) ``w_deq`` and K6's second operand."""
    return dequantize(wq, ws, dtype).T.contiguous()


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


def check_gemm_shape(m: int, k: int, n: int) -> None:
    """Raise unless K4 takes x (M, K) against W_q (N, K): K % 32 == 0 (so the
    int8 and bf16 rows the TMA loads are 16-byte aligned), K small enough
    for exact int32 sums, N % 8 == 0 (the bf16 output rows the TMA stores),
    M >= 0."""
    _check_k(k)
    if not 0 < k <= MAX_K:
        raise ValueError(f"K4 needs 0 < K <= {MAX_K} (exact int32 sums), got K = {k}")
    if n < 8 or n % 8:
        raise ValueError(f"K4 needs N % 8 == 0 and N >= 8, got N = {n}")
    if m < 0:
        raise ValueError(f"K4 needs M >= 0, got M = {m}")


def check_lora_shape(m: int, k: int, n: int, r: int) -> None:
    """Raise unless K5 takes x (M, K) against W_q (N, K) with adapters of
    rank r: K4's shapes, and r % 8 == 0 (the 16-byte rows of xa (M, r) and
    lora_b (N, r) that its TMA loads) with 0 < r <= MAX_RANK (at most one
    64-column box of each)."""
    check_gemm_shape(m, k, n)
    if r <= 0 or r % 8 or r > MAX_RANK:
        raise ValueError(f"K5 needs rank % 8 == 0 and 0 < rank <= {MAX_RANK}, got {r}")


def k5_scratch_layout(m: int, k: int, r: int):
    """K5's scratch in one byte buffer: xq (M, K) int8 at 0, s_x (M,) fp32
    at M K, xa (M, r) bf16 at the next 16-byte boundary (TMA reads it).
    Returns (s_x's offset, xa's offset, total bytes)."""
    sx_at = m * k  # K % 32 == 0: 16-byte aligned
    xa_at = (sx_at + 4 * m + 15) // 16 * 16
    return sx_at, xa_at, xa_at + 2 * m * r


def check_nt_shape(m: int, n: int, k: int) -> None:
    """Raise unless K6 takes dy (M, N) against W_q (N, K): K % 32 == 0 and
    N % 32 == 0 (the contraction N runs along 16-byte aligned bf16 rows of
    dy and of W_deq^T), M >= 0."""
    _check_k(k)
    if n % K_ALIGN or n < 1:
        raise ValueError(f"K6 needs N % {K_ALIGN} == 0, got N = {n}")
    if m < 0:
        raise ValueError(f"K6 needs M >= 0, got M = {m}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def quant_rows_cuda(x: torch.Tensor):
    """K4's first launch: (M, K) bf16 x -> (int8 (M, K), fp32 (M,)), the
    bits of ``quant_rows`` (its scales without the keepdim)."""
    m, k = x.shape
    _check_k(k)
    _check("x", x, torch.bfloat16, (m, k))
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m:
        _raise_on(_library().sam3_quant_rows(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
                                             _stream(x)), "sam3_quant_rows")
    return xq, sx


def int8_gemm_wres_cuda(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch K4 on (M, K) bf16 x, (N, K) int8 wq, (N,) fp32 ws: the row
    quantization into scratch (xq, s_x), then the s8 mainloop with the
    scaling epilogue."""
    m, k = x.shape
    n = wq.shape[0]
    check_gemm_shape(m, k, n)
    _check("x", x, torch.bfloat16, (m, k))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x.device)
        _raise_on(_library().sam3_int8_gemm(x.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                                            wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k,
                                            _stream(x)), "sam3_int8_gemm")
    return out


def int8_lora_gemm_wres_cuda(x, wq, ws, a, b, scale: float) -> torch.Tensor:
    """Launch K5 on K4's operands plus a (r, K) and b (N, r) bf16: one pass
    writes the row quantization and xa into scratch (xq, s_x, xa (M, r)),
    then the s8 mainloop with the low-rank step. The scratch is one byte
    buffer (``k5_scratch_layout``): one allocation where K4 makes two."""
    m, k = x.shape
    n, r = wq.shape[0], a.shape[0]
    check_lora_shape(m, k, n, r)
    _check("x", x, torch.bfloat16, (m, k))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    _check("lora_a", a, torch.bfloat16, (r, k))
    _check("lora_b", b, torch.bfloat16, (n, r))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        sx_at, xa_at, nbytes = k5_scratch_layout(m, k, r)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
        base = scratch.data_ptr()
        _raise_on(_library().sam3_int8_lora_gemm(
            x.data_ptr(), base, base + sx_at, base + xa_at, wq.data_ptr(), ws.data_ptr(),
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, r, float(scale), _stream(x)),
            "sam3_int8_lora_gemm")
    return out


def dequantize_t_cuda(wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """K6's first launch: (N, K) int8 wq, (N,) fp32 ws -> (K, N) bf16, the
    bits of ``dequantize_t``."""
    n, k = wq.shape
    check_nt_shape(0, n, k)
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    out = torch.empty((k, n), dtype=torch.bfloat16, device=wq.device)
    _raise_on(_library().sam3_dequant_t(wq.data_ptr(), ws.data_ptr(), out.data_ptr(), n, k,
                                        _stream(wq)), "sam3_dequant_t")
    return out


def bf16_gemm_wres_nt_cuda(dy: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch K6 on (M, N) bf16 dy, (N, K) int8 wq, (N,) fp32 ws -> (M, K):
    the dequantize-transpose into scratch (W_deq^T), then the bf16
    mainloop."""
    m, n = dy.shape
    k = wq.shape[1]
    check_nt_shape(m, n, k)
    _check("dy", dy, torch.bfloat16, (m, n))
    _check("wq", wq, torch.int8, (n, k))
    _check("ws", ws, torch.float32, (n,))
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    if m:
        wdt = torch.empty((k, n), dtype=torch.bfloat16, device=dy.device)
        _raise_on(_library().sam3_bf16_gemm_nt(dy.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                               wdt.data_ptr(), out.data_ptr(), m, n, k,
                                               _stream(dy)), "sam3_bf16_gemm_nt")
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
