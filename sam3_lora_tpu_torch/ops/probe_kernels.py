"""Binding, plain versions and launch counts of the window-kernel probes.

``csrc/probe_window.cu`` holds the probe kernels that replace the JAX
package's Pallas probes of its window kernel (``scripts/probe_window_cost.py``,
``probe_dma_floor.py``, ``probe_packed.py``):

* ``stage``: the stage ladder, the production forward (K1) with one stage
  more or less per rung (``STAGES``), on (N, P, L, 64) bf16 views of any
  strides with a contiguous last dim and 16-byte aligned rows (read by the
  forward's TMA maps, ``attention_kernel.fwd_maps``); ``pair`` takes the
  block-diagonal head-pair form (``PAIR_STAGES``, P = 2), and ``wpc`` sets
  how many heads (pairs) one CTA walks;
* ``op_rate``: y <- f(y), ``passes`` times over a resident (rows, 576) tile
  (``OPS``);
* ``pair_bwd``: the backward of the head-pair-packed layout, which is the
  port's attention backward kernel (``csrc/attention_bwd.cu``) on the pair
  view.

Beside each is its plain PyTorch version, which rounds where the JAX body
rounds (S to bf16 before PV in ``qk_pv``, P to bf16 before PV, bf16 scores in
``full_bf16s``). CPU tensors take the plain versions, CUDA tensors the
kernels, anything else is an error. Each wrapper counts its launches by
variant on ``<wrapper>.launches`` (a Counter). Nothing here runs at import.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _cuda, attention_kernel

STAGES = ("copy", "qk_pv", "qk_exp_pv", "qk_exp2_pv", "qk_fexp_pv", "qk_mexp_pv", "full",
          "full_fexp", "full_bf16s")
PAIR_STAGES = ("copy", "qk_pv", "full")
OPS = ("add_f32", "mul_f32", "exp_f32", "exp2_f32", "fast_exp2_f32", "maxreduce_f32",
       "add_bf16", "exp_bf16")
OP_COLS = 576  # one warp per row, 18 elements a lane
HEAD_DIM = 64
LOG2E = 1.4426950408889634


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.sam3_probe_stage.argtypes = ([ptr] * 4 + [i32] * 3 + [strides] * 2 + [i32] * 3
                                     + [ctypes.c_float, ptr])
    lib.sam3_probe_stage.restype = i32
    lib.sam3_probe_op.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.sam3_probe_op.restype = i32
    lib.sam3_probe_op_layout.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.sam3_probe_op_layout.restype = i32
    return lib


def _device_check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu" and not t.is_cuda:
        raise ValueError(f"{name}: no kernel for device {t.device}")


def fast_exp2(x: torch.Tensor) -> torch.Tensor:
    """2^x of an fp32 tensor as ``probe_window_cost.py::fast_exp2`` computes
    it: round half to even, clip to [-126, 127], a degree-4 polynomial on the
    fraction, and the exponent put in by bits."""
    xi = torch.clamp(torch.round(x), -126.0, 127.0)
    f = x - xi
    p = 1.0 + f * (0.6931471805599453
                   + f * (0.2402265069591007 + f * (0.05550410866482158 + f * 0.009618129107628477)))
    return p * ((xi.to(torch.int32) + 127) << 23).view(torch.float32)


def variant(name: str, pair: bool = False, wpc: int = 1) -> str:
    """The launch-count key of one stage kernel variant."""
    return f"{name}{'_pair' if pair else ''}_wpc{wpc}"


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P rounded to bf16, times V, in fp32 (the JAX ``_pv``)."""
    return torch.einsum("npqk,npkd->npqd", p.to(torch.bfloat16).float(), v.float())


def stage_plain(q, k, v, name: str, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the rung ``name`` on (N, P, L, dh) views,
    the JAX stage body head by head; the pair form computes the same."""
    if name == "copy":
        return q.clone()
    s = torch.einsum("npqd,npkd->npqk", q.float(), k.float())
    if name == "full_bf16s":
        s = s.to(torch.bfloat16) * torch.tensor(scale, dtype=torch.bfloat16)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))  # bf16
        o = torch.einsum("npqk,npkd->npqd", p.float(), v.float())
        return (o / p.float().sum(dim=-1, keepdim=True)).to(q.dtype)
    if name in ("qk_exp2_pv", "qk_fexp_pv", "full_fexp"):
        s = s * (scale * LOG2E)
    else:
        s = s * scale
    if name == "qk_pv":
        p = s
    elif name == "qk_exp_pv":
        p = torch.exp(s)
    elif name == "qk_exp2_pv":
        p = torch.exp2(s)
    elif name == "qk_fexp_pv":
        p = fast_exp2(s)
    elif name in ("qk_mexp_pv", "full"):
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    elif name == "full_fexp":
        p = fast_exp2(s - s.amax(dim=-1, keepdim=True))
    else:
        raise ValueError(f"unknown stage {name!r}")
    o = _pv(p, v)
    if name.startswith("full"):
        o = o / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def stage(q, k, v, name: str, scale: float, pair: bool = False, wpc: int = 1, o=None):
    """The rung ``name`` on (N, P, L, 64) bf16 views: the plain version for
    CPU tensors, the kernel for CUDA tensors (counted on
    ``stage.launches[variant(name, pair, wpc)]``). Writes ``o`` (a view, or
    a new contiguous tensor) and returns it."""
    _device_check("stage", q)
    if name not in (PAIR_STAGES if pair else STAGES):
        raise ValueError(f"no {'pair ' if pair else ''}stage {name!r}")
    if q.device.type == "cpu":
        out = stage_plain(q, k, v, name, scale)
        return out if o is None else o.copy_(out)
    n, p, l, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"the probes take head_dim {HEAD_DIM}, got {dh}")
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        attention_kernel._check_operand(t_name, t, q.shape)
    if o is None:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    attention_kernel._check_operand("o", o, q.shape)
    ctas = n if pair else n * p
    if wpc < 1 or ctas % wpc or ctas // wpc > 65535:
        raise ValueError(f"wpc {wpc} must divide {ctas} CTAs' work into at most 65535")
    if pair and p != 2:
        raise ValueError(f"the pair form takes P = 2, got {p}")
    maps = attention_kernel.fwd_maps(q, k, v)
    err = _library().sam3_probe_stage(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, l, p,
        attention_kernel._strides(o), maps, STAGES.index(name), int(pair), wpc, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_kernel._raise_on(err, "sam3_probe_stage", maps)
    stage.launches[variant(name, pair, wpc)] += 1
    return o


stage.launches = collections.Counter()


def op_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name.endswith("bf16") else torch.float32


def op_plain(x: torch.Tensor, name: str, passes: int) -> torch.Tensor:
    """Plain PyTorch version of ``op_rate``: the JAX ``vpu_probe`` bodies
    (``probe_window_cost.py:263-272``) applied ``passes`` times. The bf16
    exp rounds as the kernel's packed form does: -y * log2(e) to bf16, its
    2^x to bf16, then + 0.5 to bf16."""
    y = x
    bf = functools.partial(torch.tensor, dtype=torch.bfloat16, device=x.device)
    for _ in range(passes):
        if name == "add_f32":
            y = y + 1e-7
        elif name == "mul_f32":
            y = y * 1.0000001
        elif name == "exp_f32":
            y = torch.exp(-y) + 0.5
        elif name == "exp2_f32":
            y = torch.exp2(-y) + 0.5
        elif name == "fast_exp2_f32":
            y = fast_exp2(-y) + 0.5
        elif name == "maxreduce_f32":
            y = y + y.amax(dim=-1, keepdim=True) * 1e-9
        elif name == "add_bf16":
            y = y + bf(1e-3)
        elif name == "exp_bf16":
            y = torch.exp2(y * bf(-LOG2E)) + bf(0.5)
        else:
            raise ValueError(f"unknown op {name!r}")
    return y


def op_rate(x: torch.Tensor, name: str, passes: int) -> torch.Tensor:
    """``passes`` applications of the op ``name`` to a contiguous (rows, 576)
    tile (fp32, or bf16 for the ``*_bf16`` ops): the plain version for a CPU
    tensor, the kernel for a CUDA tensor (counted on
    ``op_rate.launches[name]``)."""
    _device_check("op_rate", x)
    if name not in OPS:
        raise ValueError(f"unknown op {name!r}")
    if x.dtype != op_dtype(name) or x.dim() != 2 or x.shape[1] != OP_COLS:
        raise ValueError(f"{name} takes ({OP_COLS}-wide rows of {op_dtype(name)}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return op_plain(x, name, passes)
    if not x.is_contiguous() or passes < 0:
        raise ValueError("op_rate takes a contiguous tile and passes >= 0")
    y = torch.empty_like(x)
    if x.shape[0] == 0:  # nothing to launch, nothing counted
        return y
    err = _library().sam3_probe_op(x.data_ptr(), y.data_ptr(), x.shape[0], OPS.index(name),
                                   passes, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sam3_probe_op launch failed: cudaError {err}")
    op_rate.launches[name] += 1
    return y


op_rate.launches = collections.Counter()

OP_LAYOUT = ("unroll", "rows_per_warp", "grid", "warps", "smem", "ctas_per_sm")


def op_layout(name: str, rows: int) -> dict:
    """How ``op_rate`` runs op ``name`` over ``rows`` rows on the current
    card: passes an iteration of its main pass loop (``unroll``), rows a
    warp, the grid, warps a CTA, the CTA's dynamic shared bytes (the cap on
    CTAs an SM) and CTAs an SM (``csrc/probe_window.cu::op_launch``)."""
    out = (ctypes.c_int * len(OP_LAYOUT))()
    err = _library().sam3_probe_op_layout(OPS.index(name), rows, out)
    if err != 0:
        raise RuntimeError(f"sam3_probe_op_layout failed: cudaError {err}")
    return dict(zip(OP_LAYOUT, out))


def pair_bwd_plain(q, k, v, do, scale: float):
    """Plain PyTorch version of the packed layout's backward on (N, P, L, dh)
    views (P = 2 for a head pair): ``probe_packed.py::_head_bwd`` head by
    head, which recomputes P from q and k and rounds where it does (P,
    dO / rowsum, dS and q * scale / rowsum to bf16). Returns (dq, dk, dv)."""
    bf = torch.bfloat16
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("npqd,npkd->npqk", qf, kf) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    pb = p.to(bf).float()
    dv = torch.einsum("npqk,npqd->npkd", pb, (dof * inv.to(bf).float()).to(bf).float())
    dp = torch.einsum("npqd,npkd->npqk", dof, vf)
    o_un = torch.einsum("npqk,npkd->npqd", pb, vf)
    c = inv * (dof * o_un).sum(dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(bf).float()
    dq = torch.einsum("npqk,npkd->npqd", ds, kf) * (scale * inv)
    dk = torch.einsum("npqk,npqd->npkd", ds, (qf * (scale * inv).to(bf).float()).to(bf).float())
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def pair_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of the packed layout's forward on (N, 2, L, 64) views
    of (N, L, 128) tensors: the plain version for CPU tensors (``o`` and
    ``lse`` unused); for CUDA tensors the port's backward kernel
    (``attention_kernel.attention_bwd_cuda``) from the forward's output and
    log-sum-exp, counted on ``pair_bwd.launches["bwd"]``."""
    _device_check("pair_bwd", q)
    if q.device.type == "cpu":
        return pair_bwd_plain(q, k, v, do, scale)
    grads = attention_kernel.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    pair_bwd.launches["bwd"] += 1
    return grads


pair_bwd.launches = collections.Counter()


def reset_counts() -> None:
    for fn in (stage, op_rate, pair_bwd):
        fn.launches.clear()
