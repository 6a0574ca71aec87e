"""Build, binding, plain references and autograd of the attention kernels.

``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` hold the forward and
backward CUDA kernels of every attention entry point (``window_attention.py``,
``window_qkv.py``, ``long_attention.py``). The kernels take each operand as an
(N, P, L, dh) view with its own strides, so the packed (N, L, P*dh) layout,
views of a qkv projection output and head-major (B, H, L, D) tensors are all
read in place. ``_cuda.py`` builds them, with the port's other kernels, into
one shared library at first use; this module declares their C entry points and
launches on PyTorch's current stream. Nothing here runs at import: the CPU
tests import every module on a host without ``nvcc``.

``attention_plain`` and ``attention_bwd_plain`` are the plain PyTorch versions
of the forward and the backward (explicit fp32 formulas), on (N, P, L, dh)
views; the ``*_packed_*`` functions take (N, L, P*dh) operands. The entry
points use the plain versions only for CPU tensors; ``chip_smoke.py`` holds
the kernels against them on the card.

The forward runs, with RoPE, a rotation pass (``rope_cuda``, plain version
``rope_plain``: q and k rotated once into contiguous scratch), then its main
kernel, which reads q (or its rotation), k (or its rotation) and v through
4-D TMA maps. The backward runs three kernels: a prep pass
(``attention_bwd_prep_cuda``, plain version ``attention_bwd_prep_plain``: D =
rowsum(dO o O), and with RoPE the same rotation), then the dK/dV and dQ
passes, which read q, k, v and dO through TMA maps. The maps' layout and the
checks TMA needs (``tma_map``, ``fwd_plan``, ``bwd_maps``) are plain
Python that runs on any device, so the CPU tests reach them.

Gradients: when an operand requires grad, ``attend`` and ``attend_qkv`` go
through a ``torch.autograd.Function`` whose forward also writes the fp32 row
log-sum-exp and whose backward launches the backward kernel (or, on the CPU,
runs the plain backward). Without grad the forward runs alone, as in serving.
Each entry counts its forward launches on ``entry.launches`` and its backward
launches (one per Function backward) on ``entry.bwd_launches``; the rotation
pass counts its own on ``rope_cuda.launches``. Inside a checkpoint region
that keeps the caller's tag (``remat.py``), the replay in the backward
launches no forward: it takes the first pass's output and log-sum-exp back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _cuda, remat
from .rope import apply_rope_half, apply_rope_half_inv

SUPPORTED_HEAD_DIMS = (32, 64)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _cuda.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.sam3_attention_rope.argtypes = [ptr] * 6 + [i32] * 4 + [strides, ptr]
    lib.sam3_attention_rope.restype = i32
    lib.sam3_attention_fwd.argtypes = [ptr] * 9 + [i32] * 5 + [strides, strides, ctypes.c_float,
                                                               ptr]
    lib.sam3_attention_fwd.restype = i32
    lib.sam3_attention_bwd_prep.argtypes = [ptr] * 10 + [i32] * 5 + [strides, ptr]
    lib.sam3_attention_bwd_prep.restype = i32
    lib.sam3_attention_bwd.argtypes = [ptr] * 14 + [i32] * 5 + [strides, strides, ctypes.c_float,
                                                                ptr]
    lib.sam3_attention_bwd.restype = i32
    return lib


def _strides(*views: torch.Tensor):
    """The (n, p, l) strides of (N, P, L, dh) views, as the C array the
    kernels take."""
    flat = [s for t in views for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_operand(name: str, t: torch.Tensor, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    _check_layout(name, t, shape)


def _check_layout(name: str, t: torch.Tensor, shape) -> None:
    """Dtype, shape, strides and alignment of a kernel operand, on any
    device."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    # 16-byte vector loads: unit last-dim stride, the sequence, head and row
    # strides and the base address aligned to 8 bf16 elements
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous last dim and 16-byte aligned rows, "
            f"got strides {t.stride()}"
        )


_TILE = 64  # rows of a TMA box and of a CTA; the prep pads lse and D to whole tiles
_MAP_REFUSED = 100000  # the C entries' code for a refused TMA map, + CUresult


def _check_cuda(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _check_call(q, k, v, cos, sin) -> Tuple[int, int, int, int]:
    """Checks (N, P, L, dh) views q, k, v and the tables on any device;
    returns N, P, L, dh."""
    if q.dim() != 4:
        raise ValueError(f"q must be an (N, P, L, dh) view, got {tuple(q.shape)}")
    n, p, l, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t, q.shape)
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin go together")
    if cos is not None:
        for name, t in (("cos", cos), ("sin", sin)):
            if t.device != q.device or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 on {q.device}")
            if tuple(t.shape) != (l, dh // 2) or not t.is_contiguous():
                raise ValueError(
                    f"{name} must be contiguous ({l}, {dh // 2}), got {tuple(t.shape)}"
                )
    if n * p > 65535:
        raise ValueError(f"N*P = {n * p} exceeds the grid limit")
    return n, p, l, dh


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, entry: str, maps) -> None:
    """The error of a C entry point that encodes TMA maps, if any."""
    if err >= _MAP_REFUSED:
        raise RuntimeError(f"{entry}: cuTensorMapEncodeTiled refused a TMA map, "
                           f"CUresult {err - _MAP_REFUSED}; maps {list(maps)}")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def rope_plain(q, k, cos, sin):
    """Plain PyTorch version of the forward's rotation pass (and of the
    backward prep's): q and k rotated by the (L, dh/2) tables,
    ``apply_rope_half`` (fp32, rounded to q's dtype)."""
    return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)


def rope_cuda(q, k, cos, sin, qr=None, kr=None):
    """Launch the rotation pass on (N, P, L, dh) bf16 CUDA views q, k: their
    rotation, as ``rope_plain`` gives it bit for bit, into the contiguous
    (N, P, L, dh) ``qr``, ``kr`` (new tensors by default), which it returns.
    Counted on ``rope_cuda.launches``."""
    n, p, l, dh = _check_call(q, k, k, cos, sin)
    if cos is None:
        raise ValueError("the rotation pass needs the cos and sin tables")
    _check_cuda(q=q, k=k, cos=cos)
    qr = torch.empty(q.shape, dtype=q.dtype, device=q.device) if qr is None else qr
    kr = torch.empty(q.shape, dtype=q.dtype, device=q.device) if kr is None else kr
    for name, t in (("qr", qr), ("kr", kr)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} {q.dtype} CUDA tensor")
    err = _library().sam3_attention_rope(
        q.data_ptr(), k.data_ptr(), qr.data_ptr(), kr.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        n, l, p, dh, _strides(q, k), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "sam3_attention_rope", [])
    rope_cuda.launches += 1
    return qr, kr


rope_cuda.launches = 0


def fwd_maps(q, k, v):
    """The three TMA maps of the forward's main kernel (q or its rotation, k
    or its rotation, v), as the C array ``sam3_attention_fwd`` and
    ``sam3_probe_stage`` take. Raises ValueError for a view TMA cannot
    read (``tma_map``)."""
    flat = [x for name, t in (("q", q), ("k", k), ("v", v)) for x in tma_map(name, t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _geometry(t: torch.Tensor, head_dim: Optional[int]):
    """(shape, strides) of the (N, P, L, dh) view of ``t``: ``t`` itself
    when ``head_dim`` is None, else the heads of a packed (N, L, P*dh)
    tensor, worked out without building the view."""
    if head_dim is None:
        return tuple(t.shape), t.stride()
    n, l, w = t.shape
    sn, sl, sd = t.stride()
    return (n, w // head_dim, l, head_dim), (sn, head_dim * sd, sl, sd)


class _FwdPlan:
    """What one layout of the forward's operands needs at a launch, worked
    out once: the sizes, the TMA maps of the main kernel's q, k (or their
    rotation's scratch) and v, and the (n, p, l) strides of q, k and o, as
    the C arrays ``sam3_attention_fwd`` takes."""

    def __init__(self, q, k, v, o, rope: bool):
        self.n, self.p, self.l, self.dh = q.shape
        self.numel = q.numel()
        qm = km = torch.empty(q.shape, dtype=q.dtype, device="meta") if rope else None
        self.maps = fwd_maps(qm if rope else q, km if rope else k, v)
        self.strides = _strides(q, k, o)


def fwd_plan(q, k, v, o, head_dim: Optional[int] = None, cos=None, sin=None) -> _FwdPlan:
    """The forward's checks, on any device, for operands in an entry's
    layout (packed (N, L, P*head_dim), or (N, P, L, dh) views when
    ``head_dim`` is None), and the plan of their layout (``_layout_plan``:
    worked out once per layout). Raises ValueError, saying why, for anything
    the kernels do not take: dtype, shape, a last dim that is not
    contiguous, a base or stride not 16-byte aligned, a stride TMA refuses,
    tables of the wrong shape or type."""
    rope = cos is not None
    tables = ()
    if rope and sin is not None:
        tables = (cos.shape, cos.dtype, cos.device == q.device, cos.is_contiguous(),
                  sin.shape, sin.dtype, sin.device == q.device, sin.is_contiguous())
    try:
        geoms = tuple(_geometry(t, head_dim) for t in (q, k, v, o))
    except ValueError:  # not (N, L, P*dh)
        geoms = None
    plan = None
    if geoms is not None and rope == (sin is not None) and (
            head_dim is None or q.shape[-1] % head_dim == 0):
        plan = _layout_plan(geoms, (q.dtype, k.dtype, v.dtype, o.dtype), tables)
    if plan is None:  # not a layout the kernels take: say why
        if head_dim is not None and (q.dim() != 3 or q.shape[-1] % head_dim):
            raise ValueError(f"q must be (N, L, P*{head_dim}), got {tuple(q.shape)}")
        views = [_as_heads(t, head_dim) for t in (q, k, v, o)]
        _check_call(*views[:3], cos, sin)
        _check_layout("o", views[3], views[0].shape)
        for name, t in zip(("q", "k", "v"), views):
            tma_map(name, t)
        raise ValueError("the forward takes no such operands")  # a check above raised first
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows, "
                             f"got a base at {t.data_ptr()} (not 16-byte aligned)")
    return plan


@functools.lru_cache(maxsize=256)
def _layout_plan(geoms, dtypes, tables) -> Optional[_FwdPlan]:
    """The forward's ``_FwdPlan`` for (N, P, L, dh) views of these shapes,
    strides and dtypes and these tables (shape, dtype, same device,
    contiguous; none without RoPE), or None if the kernels do not take
    them: the checks of ``_check_call``, ``_check_layout`` and ``tma_map``
    on meta tensors of the layout, which depend on it alone."""
    try:
        q, k, v, o = (torch.empty_strided(g[0], g[1], dtype=d, device="meta")
                      for g, d in zip(geoms, dtypes))
        cos = sin = None
        if tables:
            cs, cd, c_dev, c_cont, ss, sd, s_dev, s_cont = tables
            if not (c_dev and c_cont and s_dev and s_cont):
                return None
            cos, sin = (torch.empty(sh, dtype=d, device="meta") for sh, d in ((cs, cd), (ss, sd)))
        _check_call(q, k, v, cos, sin)
        _check_layout("o", o, q.shape)
        return _FwdPlan(q, k, v, o, bool(tables))
    except ValueError:
        return None


def _launch_fwd(q, k, v, o, head_dim, scale, cos, sin, with_lse: bool):
    """The forward on CUDA operands in the entry's layout (packed (N, L,
    P*head_dim), or (N, P, L, dh) views when ``head_dim`` is None) into
    ``o`` of that layout: the checks and maps of their layout once
    (``fwd_plan``), then per call the devices, the bases, the scratch and
    one C call (the rotation pass with tables, then the main kernel).
    Returns the (N, P, L) fp32 log-sum-exp with ``with_lse``, else None."""
    _check_cuda(q=q, k=k, v=v, o=o)
    plan = fwd_plan(q, k, v, o, head_dim, cos, sin)
    n, p, l, dh = plan.n, plan.p, plan.l, plan.dh
    qm, km = q.data_ptr(), k.data_ptr()
    if cos is not None:
        scratch = torch.empty(2 * plan.numel, dtype=q.dtype, device=q.device)
        qm = scratch.data_ptr()
        km = qm + plan.numel * scratch.element_size()
    lse = torch.empty((n, p, l), dtype=torch.float32, device=q.device) if with_lse else None
    err = _library().sam3_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), qm, km, _ptr(cos),
        _ptr(sin), n, l, p, dh, 1, plan.strides, plan.maps, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "sam3_attention_fwd", plan.maps)
    if cos is not None:
        rope_cuda.launches += 1
    return lse


def attention_cuda(q, k, v, scale: float, cos=None, sin=None, o=None, with_lse: bool = False):
    """Launch the forward on (N, P, L, dh) bf16 CUDA views of any strides
    with a contiguous last dim and 16-byte aligned rows: with tables, the
    rotation pass (counted on ``rope_cuda.launches``), then the main kernel.
    Writes ``o`` (an (N, P, L, dh) view; a new contiguous tensor by default)
    and returns it, with ``with_lse`` also its (N, P, L) fp32 row
    log-sum-exp. Raises on anything the kernels do not take
    (``fwd_plan``)."""
    if o is None:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _launch_fwd(q, k, v, o, None, scale, cos, sin, with_lse)
    return (o, lse) if with_lse else o


def tma_map(name: str, t: torch.Tensor):
    """The 4-D TMA map of an (N, P, L, dh) bf16 view as the forward and
    backward C entry points take it: [extents of dimensions 1..3, their
    strides in bytes, slots, 0]. Dimension 0 is the contiguous dh;
    dimensions 1..3 are the view's L, P and N ordered by increasing stride
    (a dimension of extent 1 is never stepped and goes last, with the view's
    span as its stride); ``slots`` is the position of L | P << 4 | N << 8.
    A box is (dh, 64 rows). Raises ValueError for a view TMA cannot read: a
    last dim that is not contiguous, a base not 16-byte aligned, a stride
    that is not a positive multiple of 16 bytes."""
    if t.dim() != 4 or t.shape[3] not in SUPPORTED_HEAD_DIMS or t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be an (N, P, L, dh) bfloat16 view with dh in "
                         f"{SUPPORTED_HEAD_DIMS}, got {t.dtype} {tuple(t.shape)}")
    spec = _map_spec(tuple(t.shape), t.stride())
    if spec is None or t.data_ptr() % 16:
        raise ValueError(f"{name} is not a TMA view: it needs a contiguous last dim, a 16-byte "
                         f"aligned base and strides of 16-byte multiples (aligned rows), got "
                         f"strides {t.stride()}")
    return list(spec)


@functools.lru_cache(maxsize=512)
def _map_spec(shape, strides):
    """``tma_map`` of a bf16 view of this shape and these strides (in
    elements), or None where TMA cannot read it."""
    n, p, l, dh = shape
    sn, sp, sl, sd = strides
    span = dh + sum((e - 1) * st for e, st in ((n, sn), (p, sp), (l, sl)))
    span = -(-span // 8) * 8
    dims = [(st if e > 1 else span, e, which)
            for which, (e, st) in enumerate(((l, sl), (p, sp), (n, sn)))]
    if sd != 1 or any(st <= 0 or st % 8 for st, _, _ in dims):
        return None
    dims.sort(key=lambda d: (d[0], d[2]))
    slot = {which: i + 1 for i, (_, _, which) in enumerate(dims)}
    return tuple([e for _, e, _ in dims] + [st * 2 for st, _, _ in dims]
                 + [slot[0] | slot[1] << 4 | slot[2] << 8, 0])


def bwd_maps(qm, km, v, do):
    """The four maps of the backward's main kernels (q or its rotation, k or
    its rotation, v, dO), as the C array ``sam3_attention_bwd`` takes."""
    flat = [x for name, t in (("q", qm), ("k", km), ("v", v), ("do", do)) for x in tma_map(name, t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def attention_bwd_prep_plain(q, k, o, do, cos=None, sin=None):
    """Plain PyTorch version of the backward's prep kernel on (N, P, L, dh)
    views: (q_rot, k_rot, D). q and k rotated by the tables
    (``apply_rope_half``: fp32, rounded to q's dtype), or q and k themselves
    without tables; D = rowsum(dO o O) in fp32, summed in the kernel's order
    (each lane of dh/8 adds its 8 exact bf16 products in sequence, then a
    butterfly over the lanes), so the kernel gives the same bits."""
    if cos is not None:
        q, k = rope_plain(q, k, cos, sin)
    prod = (do.float() * o.float()).unflatten(-1, (-1, 8))  # (N, P, L, dh/8, 8)
    acc = prod[..., 0]
    for j in range(1, 8):
        acc = acc + prod[..., j]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return q, k, acc[..., 0]


def _prep_buffers(q, k, cos):
    """The main kernels' q and k (new contiguous tensors for the rotation
    with RoPE, else q and k themselves) and the (2, N*P, lpad) fp32 scratch
    of lse * log2(e) and D, padded to whole tiles."""
    n, p, l, dh = q.shape
    lpad = -(-l // _TILE) * _TILE
    scratch = torch.empty((2, n * p, lpad), dtype=torch.float32, device=q.device)
    if cos is None:
        return q, k, scratch
    qm, km = (torch.empty((n, p, l, dh), dtype=q.dtype, device=q.device) for _ in range(2))
    return qm, km, scratch


def _check_bwd_call(q, k, v, o, lse, do, cos, sin):
    """``_check_call`` (``v`` None: q and k alone) and the backward's own
    operands; returns dO, copied when its view is not one the kernels read."""
    n, p, l, _ = _check_call(q, k, k if v is None else v, cos, sin)
    _check_cuda(q=q, k=k, **({} if v is None else {"v": v}))
    if do.stride(3) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    _check_operand("o", o, q.shape)
    _check_operand("do", do, q.shape)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (n, p, l) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({n}, {p}, {l})")
    return do


def attention_bwd_prep_cuda(q, k, o, do, lse, cos=None, sin=None):
    """Launch the backward's prep kernel alone on (N, P, L, dh) CUDA views
    and the forward's (N, P, L) log-sum-exp: (q_rot, k_rot, D) as
    ``attention_bwd_prep_plain`` gives them."""
    do = _check_bwd_call(q, k, None, o, lse, do, cos, sin)
    n, p, l, dh = q.shape
    qm, km, scratch = _prep_buffers(q, k, cos)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().sam3_attention_bwd_prep(
        q.data_ptr(), k.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), qm.data_ptr(),
        km.data_ptr(), scratch.data_ptr(), _ptr(cos), _ptr(sin), n, l, p, dh, scratch.shape[2],
        _strides(q, k, o, do), stream,
    )
    if err != 0:
        raise RuntimeError(f"sam3_attention_bwd_prep launch failed: cudaError {err}")
    return qm, km, scratch[1].view(n, p, -1)[..., :l]


def attention_bwd_cuda(q, k, v, o, lse, do, scale: float, cos=None, sin=None, out=None):
    """Launch the backward kernels on (N, P, L, dh) views: (dq, dk, dv) of the
    forward's output ``o`` (with its log-sum-exp ``lse``) for the upstream
    gradient ``do``, with respect to the unrotated q and k. ``out`` may give
    the three outputs as views (the column blocks of one packed-qkv
    gradient); otherwise they are new contiguous tensors. Raises for a view
    the kernels do not read (``tma_map``)."""
    do = _check_bwd_call(q, k, v, o, lse, do, cos, sin)
    n, p, l, dh = q.shape
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    for name, t in zip(("dq", "dk", "dv"), out):
        _check_operand(name, t, q.shape)
    dq, dk, dv = out
    qm, km, scratch = _prep_buffers(q, k, cos)
    maps = bwd_maps(qm, km, v, do)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().sam3_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        qm.data_ptr(), km.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(cos), _ptr(sin), n, l, p, dh, scratch.shape[2],
        _strides(q, k, o, do, dq, dk, dv), maps, float(scale), stream,
    )
    _raise_on(err, "sam3_attention_bwd", maps)
    return dq, dk, dv


def attention_packed_cuda(q, k, v, scale: float, head_dim: int, cos=None, sin=None,
                          with_lse: bool = False):
    """``attention_cuda`` on (N, L, P*head_dim) operands (rows may be
    strided); returns a new contiguous (N, L, P*head_dim) output, and with
    ``with_lse`` also its (N, P, L) fp32 row log-sum-exp."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _launch_fwd(q, k, v, o, head_dim, scale, cos, sin, with_lse)
    return (o, lse) if with_lse else o


def attention_packed_bwd_cuda(q, k, v, o, lse, do, scale: float, head_dim: int, cos=None,
                              sin=None, out=None):
    """``attention_bwd_cuda`` on (N, L, P*head_dim) operands; ``out`` may
    give the outputs as (N, L, P*head_dim) views with row strides, otherwise
    they are new contiguous tensors of that shape."""
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    attention_bwd_cuda(*(_heads(t, head_dim) for t in (q, k, v, o)), lse, _heads(do, head_dim),
                       scale, cos, sin, out=tuple(_heads(t, head_dim) for t in out))
    return out


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    n, l, pd = t.shape
    return t.reshape(n, l, pd // head_dim, head_dim).transpose(1, 2)  # (N, P, L, dh)


def _merge(t: torch.Tensor) -> torch.Tensor:
    n, p, l, dh = t.shape
    return t.transpose(1, 2).reshape(n, l, p * dh)


def _as_heads(t: torch.Tensor, head_dim: Optional[int]) -> torch.Tensor:
    """Packed (N, L, P*head_dim) -> its (N, P, L, dh) view; ``head_dim``
    None means ``t`` already is one."""
    return t if head_dim is None else _heads(t, head_dim)


def attention_plain(q, k, v, scale: float, cos=None, sin=None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel on (N, P, L, dh) views:
    optional rotate-half RoPE, fp32 scores, fp32 softmax with the max shift,
    fp32 P@V, cast back to q's dtype."""
    if cos is not None:
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
    s = torch.einsum("npqd,npkd->npqk", q.float(), k.float()) * float(scale)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("npqk,npkd->npqd", probs, v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, o, do, scale: float, cos=None, sin=None):
    """Plain PyTorch version of the backward kernel on (N, P, L, dh) views,
    in explicit fp32 formulas: P recomputed with the max-shift softmax,
    dV = P^T dO, dS = P o (dO V^T - rowsum(dO o O)), dQ = dS K * scale,
    dK = dS^T Q * scale, then the inverse RoPE on dQ and dK. Returns
    (dq, dk, dv) in q's dtype, with respect to the unrotated q and k."""
    dtype = q.dtype
    if cos is not None:
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
    qf, kf, vf, dof, of = (t.float() for t in (q, k, v, do, o))
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
    return tuple(t.to(dtype) for t in (dq, dk, dv))


def attention_packed_plain(q, k, v, scale: float, head_dim: int, cos=None, sin=None):
    """``attention_plain`` on (N, L, P*head_dim) operands."""
    return _merge(attention_plain(*(_heads(t, head_dim) for t in (q, k, v)), scale, cos, sin))


def attention_packed_bwd_plain(q, k, v, o, do, scale: float, head_dim: int, cos=None, sin=None):
    """``attention_bwd_plain`` on (N, L, P*head_dim) operands."""
    grads = attention_bwd_plain(*(_heads(t, head_dim) for t in (q, k, v, o, do)), scale, cos, sin)
    return tuple(_merge(g) for g in grads)


def _device_check(entry, q: torch.Tensor) -> None:
    if q.device.type != "cpu" and not q.is_cuda:
        raise ValueError(f"{entry.__name__}: no kernel for device {q.device}")


def _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse: bool):
    """The forward on the operands' device, in their layout (packed, or
    (N, P, L, dh) when ``head_dim`` is None): the plain version for CPU
    tensors, the kernel (counted on ``entry.launches``) for CUDA tensors. In
    a checkpoint region that keeps this call's tag, the backward's replay
    takes the first pass's result back instead (``remat.kept``)."""
    _device_check(entry, q)

    def compute():
        if q.device.type == "cpu":
            o = attention_plain(*(_as_heads(t, head_dim) for t in (q, k, v)), scale, cos, sin)
            o, lse = (o if head_dim is None else _merge(o)), None
        else:
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            lse = _launch_fwd(q, k, v, o, head_dim, scale, cos, sin, with_lse)
            entry.launches += 1
        return (o, lse) if with_lse else o

    return remat.kept(compute)


def _backward(entry, q, k, v, o, lse, do, scale, head_dim, cos, sin, out=None):
    """The backward on the operands' device and in their layout, counted on
    ``entry.bwd_launches`` for CUDA tensors. ``out`` may give the three
    gradients' buffers (the column blocks of one packed-qkv gradient)."""
    views = [_as_heads(t, head_dim) for t in (q, k, v, o, do)]
    if q.device.type == "cpu":
        grads = attention_bwd_plain(*views, scale, cos, sin)
        return grads if head_dim is None else tuple(_merge(g) for g in grads)
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    attention_bwd_cuda(*views[:4], lse, views[4], scale, cos, sin,
                       out=tuple(_as_heads(t, head_dim) for t in out))
    entry.bwd_launches += 1
    return out


class _Attention(torch.autograd.Function):
    """Attention over separate q, k, v (packed (N, L, P*dh), or (N, P, L, dh)
    when ``head_dim`` is None) with the kernel backward."""

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
    gradient. Operands are packed (N, L, P*head_dim), or (N, P, L, dh)
    views when ``head_dim`` is None; the output has the same layout."""
    if _needs_grad(q, k, v):
        _device_check(entry, q)
        return _Attention.apply(entry, scale, head_dim, q, k, v, cos, sin)
    return _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=False)


def attend_qkv(entry, qkv, scale, head_dim, cos=None, sin=None):
    """``attend`` over the packed (N, L, 3*P*dh) qkv projection output, whose
    gradient comes back as one tensor. Counted on ``entry``'s counters."""
    if _needs_grad(qkv):
        _device_check(entry, qkv)
        return _PackedAttentionQKV.apply(entry, scale, head_dim, qkv, cos, sin)
    q, k, v = qkv.chunk(3, dim=-1)
    return _forward(entry, q, k, v, scale, head_dim, cos, sin, with_lse=False)
