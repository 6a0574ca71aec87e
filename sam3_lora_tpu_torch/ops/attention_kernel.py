"""Build, binding, plain references and autograd of the packed attention kernels.

``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` hold the forward and
backward CUDA kernels of the three attention entry points
(``window_attention.py``, ``long_attention.py``). This module compiles them
with ``nvcc`` (one process per source, all started together, then one link)
into a shared library under ``_build/`` at first use, keyed on a hash of the
sources, loads it with ``ctypes``, and launches on PyTorch's current stream.
Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.

``attention_packed_plain`` and ``attention_packed_bwd_plain`` are the plain
PyTorch versions of the forward and the backward (explicit fp32 formulas).
The entry points use them only for CPU tensors; ``chip_smoke.py`` holds the
kernels against them on the card.

Gradients: when an operand requires grad, ``attend`` and ``attend_qkv`` go
through a ``torch.autograd.Function`` whose forward also writes the fp32 row
log-sum-exp and whose backward launches the backward kernel (or, on the CPU,
runs the plain backward). Without grad the forward runs alone, as in serving.
Each entry counts its forward launches on ``entry.launches`` and its backward
launches (one per Function backward) on ``entry.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

from .rope import apply_rope_half, apply_rope_half_inv

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("attention_fwd.cu", "attention_bwd.cu")
_HEADERS = ("attention_common.cuh",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
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


def _run(procs) -> None:
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=1)
def build() -> str:
    """Compile the kernel library if this source hash has no build yet;
    return the path of the shared library."""
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = os.path.join(_BUILD_DIR, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libsam3_attention.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", obj, os.path.join(_CSRC_DIR, name)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        _run(procs)
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *_NVCC_FLAGS, "-shared", "-o", so, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(so, lib)  # atomic: a concurrent reader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sam3_attention_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [i64] * 8 + [ctypes.c_float, ptr]
    lib.sam3_attention_fwd.restype = i32
    lib.sam3_attention_bwd.argtypes = [ptr] * 12 + [i32] * 4 + [i64] * 16 + [ctypes.c_float, ptr]
    lib.sam3_attention_bwd.restype = i32
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


def _check_call(q, k, v, head_dim, cos, sin) -> Tuple[int, int, int]:
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
    return n, l, pd // head_dim


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def attention_packed_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    with_lse: bool = False,
):
    """Launch the forward kernel on (N, L, P*head_dim) bf16 CUDA operands;
    returns a new contiguous (N, L, P*head_dim) bf16 output, and with
    ``with_lse`` also its (N, P, L) fp32 row log-sum-exp. Raises on anything
    the kernel does not take."""
    n, l, p = _check_call(q, k, v, head_dim, cos, sin)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((n, p, l), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().sam3_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse),
        _ptr(cos), _ptr(sin), n, l, p, head_dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"sam3_attention_fwd launch failed: cudaError {err}")
    return (o, lse) if with_lse else o


def attention_packed_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels: (dq, dk, dv) of the forward's output o
    (with its log-sum-exp ``lse``) for the upstream gradient ``do``, with
    respect to the unrotated q and k. ``out`` may give the three outputs as
    (N, L, P*head_dim) bf16 views with row strides (the three column blocks
    of one packed-qkv gradient); otherwise they are allocated."""
    n, l, p = _check_call(q, k, v, head_dim, cos, sin)
    if do.stride(-1) != 1 or do.stride(0) % 8 or do.stride(1) % 8 or do.data_ptr() % 16:
        do = do.contiguous()
    _check_operand("o", o, q.shape)
    _check_operand("do", do, q.shape)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (n, p, l) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({n}, {p}, {l})")
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    for name, t in zip(("dq", "dk", "dv"), out):
        _check_operand(name, t, q.shape)
    dq, dk, dv = out
    scratch = torch.empty((n, p, l), dtype=torch.float32, device=q.device)  # rowsum(dO o O)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().sam3_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(cos), _ptr(sin), n, l, p, head_dim,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), do.stride(0), do.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1), dv.stride(0), dv.stride(1),
        float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"sam3_attention_bwd launch failed: cudaError {err}")
    return dq, dk, dv


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    n, l, pd = t.shape
    return t.reshape(n, l, pd // head_dim, head_dim).transpose(1, 2)  # (N, P, L, dh)


def _merge(t: torch.Tensor) -> torch.Tensor:
    n, p, l, dh = t.shape
    return t.transpose(1, 2).reshape(n, l, p * dh)


def attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: heads split out of the
    packed (N, L, P*head_dim) layout, optional rotate-half RoPE, fp32 scores,
    fp32 softmax with the max shift, fp32 P@V, cast back to q's dtype."""
    qh, kh, vh = (_heads(t, head_dim) for t in (q, k, v))
    if cos is not None:
        qh = apply_rope_half(qh, cos, sin)
        kh = apply_rope_half(kh, cos, sin)
    s = torch.einsum("npqd,npkd->npqk", qh.float(), kh.float()) * float(scale)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("npqk,npkd->npqd", probs, vh.float())
    return _merge(out).to(q.dtype)


def attention_packed_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    head_dim: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, in explicit fp32
    formulas: P recomputed with the max-shift softmax, dV = P^T dO,
    dS = P o (dO V^T - rowsum(dO o O)), dQ = dS K * scale, dK = dS^T Q *
    scale, then the inverse RoPE on dQ and dK. Returns (dq, dk, dv) in q's
    dtype, with respect to the unrotated q and k."""
    qh, kh, vh = (_heads(t, head_dim) for t in (q, k, v))
    if cos is not None:
        qh = apply_rope_half(qh, cos, sin)
        kh = apply_rope_half(kh, cos, sin)
    qf, kf, vf = qh.float(), kh.float(), vh.float()
    dof, of = _heads(do, head_dim).float(), _heads(o, head_dim).float()
    s = torch.einsum("npqd,npkd->npqk", qf, kf) * float(scale)
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("npqk,npqd->npkd", p, dof)
    dp = torch.einsum("npqd,npkd->npqk", dof, vf)
    rowdot = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - rowdot)
    dq = torch.einsum("npqk,npkd->npqd", ds, kf) * float(scale)
    dk = torch.einsum("npqk,npqd->npkd", ds, qf) * float(scale)
    if cos is not None:
        dq = apply_rope_half_inv(dq, cos, sin)
        dk = apply_rope_half_inv(dk, cos, sin)
    return tuple(_merge(t).to(q.dtype) for t in (dq, dk, dv))


def _device_check(entry, q: torch.Tensor) -> None:
    if q.device.type != "cpu" and not q.is_cuda:
        raise ValueError(f"{entry.__name__}: no kernel for device {q.device}")


def _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse: bool):
    """The forward on the operands' device: the plain version for CPU tensors,
    the kernel (counted on ``entry.launches``) for CUDA tensors."""
    _device_check(entry, q)
    if q.device.type == "cpu":
        out = attention_packed_plain(q, k, v, scale, head_dim, cos, sin)
        return (out, None) if with_lse else out
    out = attention_packed_cuda(q, k, v, scale, head_dim, cos, sin, with_lse=with_lse)
    entry.launches += 1
    return out


def _backward(entry, q, k, v, o, lse, do, scale, head_dim, cos, sin, out=None):
    """The backward on the operands' device, counted on ``entry.bwd_launches``
    for CUDA tensors."""
    if q.device.type == "cpu":
        return attention_packed_bwd_plain(q, k, v, o, do, scale, head_dim, cos, sin)
    grads = attention_packed_bwd_cuda(q, k, v, o, lse, do, scale, head_dim, cos, sin, out)
    entry.bwd_launches += 1
    return grads


class _PackedAttention(torch.autograd.Function):
    """Attention over separate (N, L, P*dh) q, k, v with the kernel backward."""

    @staticmethod
    def forward(ctx, entry, scale, head_dim, q, k, v, cos, sin):
        o, lse = _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, cos, sin)
        ctx.entry, ctx.scale, ctx.head_dim = entry, scale, head_dim
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cos, sin = ctx.saved_tensors
        dq, dk, dv = _backward(ctx.entry, q, k, v, o, lse, do, ctx.scale, ctx.head_dim, cos, sin)
        return None, None, None, dq, dk, dv, None, None


class _PackedAttentionQKV(torch.autograd.Function):
    """Attention over the packed (N, L, 3*P*dh) output of a qkv projection.
    Its backward writes dq, dk and dv into one gradient of that shape, so
    autograd builds no three zero-filled buffers to add up."""

    @staticmethod
    def forward(ctx, entry, scale, head_dim, qkv, cos, sin):
        q, k, v = qkv.chunk(3, dim=-1)
        o, lse = _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=True)
        ctx.save_for_backward(qkv, o, lse, cos, sin)
        ctx.entry, ctx.scale, ctx.head_dim = entry, scale, head_dim
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, cos, sin = ctx.saved_tensors
        q, k, v = qkv.chunk(3, dim=-1)
        if qkv.device.type == "cpu":
            grads = _backward(ctx.entry, q, k, v, o, lse, do, ctx.scale, ctx.head_dim, cos, sin)
            return None, None, None, torch.cat(grads, dim=-1), None, None
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _backward(ctx.entry, q, k, v, o, lse, do, ctx.scale, ctx.head_dim, cos, sin,
                  out=tuple(dqkv.chunk(3, dim=-1)))
        return None, None, None, dqkv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attend(entry, q, k, v, scale, head_dim, cos=None, sin=None):
    """Route an entry point's call by the device of its operands: the plain
    version for CPU tensors, the kernel for CUDA tensors, an error for
    anything else; through the autograd Function when an operand needs a
    gradient."""
    if _needs_grad(q, k, v):
        _device_check(entry, q)
        return _PackedAttention.apply(entry, scale, head_dim, q, k, v, cos, sin)
    return _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=False)


def attend_qkv(entry, qkv, scale, head_dim, cos=None, sin=None):
    """``attend`` over the packed (N, L, 3*P*dh) qkv projection output, whose
    gradient comes back as one tensor. Counted on ``entry``'s counters."""
    if _needs_grad(qkv):
        _device_check(entry, qkv)
        return _PackedAttentionQKV.apply(entry, scale, head_dim, qkv, cos, sin)
    q, k, v = qkv.chunk(3, dim=-1)
    return _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=False)
