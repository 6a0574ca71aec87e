"""Build, binding and plain reference of the packed attention forward kernel.

``csrc/attention_fwd.cu`` holds one CUDA kernel for the three attention entry
points (``window_attention.py``, ``long_attention.py``). This module compiles
it with ``nvcc`` into a shared library under ``_build/`` at first use (keyed on
a hash of the sources), loads it with ``ctypes``, and launches it on PyTorch's
current stream. Nothing here runs at import: the CPU tests import every
module on a host without ``nvcc``.

``attention_packed_plain`` is the plain PyTorch version of the same function
(einsum, fp32 softmax, einsum). The entry points use it only for CPU tensors,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from .rope import apply_rope_half

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("attention_fwd.cu",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SUPPORTED_HEAD_DIMS = (32, 64)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=1)
def build() -> str:
    """Compile the kernel library if this source hash has no build yet;
    return the path of the shared library."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD_DIR, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libsam3_attention.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC_DIR, s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent reader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    fn = lib.sam3_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _check_operand(name: str, t: torch.Tensor, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    # 16-byte vector loads: unit last-dim stride, row strides and the base
    # address aligned to 8 bf16 elements
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous last dim and 16-byte aligned rows, "
            f"got strides {t.stride()}"
        )


def attention_packed_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel on (N, L, P*head_dim) bf16 CUDA operands; returns a
    new contiguous (N, L, P*head_dim) bf16 tensor. Raises on anything the
    kernel does not take."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {SUPPORTED_HEAD_DIMS}")
    if q.dim() != 3 or q.shape[-1] % head_dim:
        raise ValueError(f"q must be (N, L, P*{head_dim}), got {tuple(q.shape)}")
    n, l, pd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (n, l, pd))
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin go together")
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            if t.device != q.device or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 on {q.device}")
            if tuple(t.shape) != (l, head_dim // 2) or not t.is_contiguous():
                raise ValueError(
                    f"{name} must be contiguous ({l}, {head_dim // 2}), "
                    f"got {tuple(t.shape)}"
                )
    if n * (pd // head_dim) > 65535:
        raise ValueError(f"N*P = {n * (pd // head_dim)} exceeds the grid limit")
    o = torch.empty((n, l, pd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().sam3_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None,
        n, l, pd // head_dim, head_dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"sam3_attention_fwd launch failed: cudaError {err}")
    return o


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: heads split out of the packed
    (N, L, P*head_dim) layout, optional rotate-half RoPE, fp32 scores, fp32
    softmax with the max shift, fp32 P@V, cast back to q's dtype."""
    n, l, pd = q.shape
    p = pd // head_dim

    def heads(t):
        return t.reshape(n, l, p, head_dim).transpose(1, 2)  # (N, P, L, dh)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if cos is not None:
        qh = apply_rope_half(qh, cos, sin)
        kh = apply_rope_half(kh, cos, sin)
    s = torch.einsum("npqd,npkd->npqk", qh.float(), kh.float()) * float(scale)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("npqk,npkd->npqd", probs, vh.float())
    return out.transpose(1, 2).reshape(n, l, pd).to(q.dtype)


def dispatch(entry, q, k, v, scale, head_dim, cos=None, sin=None):
    """Route an entry point's call by the device of its operands: the plain
    version for CPU tensors, the kernel (counted on ``entry.launches``) for
    CUDA tensors, an error for anything else."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, scale, head_dim, cos, sin)
    if not q.is_cuda:
        raise ValueError(f"{entry.__name__}: no kernel for device {q.device}")
    out = attention_packed_cuda(q, k, v, scale, head_dim, cos, sin)
    entry.launches += 1
    return out
