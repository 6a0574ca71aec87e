"""The reference's arithmetic: every product of the model goes through here.

``NUM`` says in which precision the reference computes its products; the
model's compute type (``reference.model.build``) says in which it keeps its
activations, and every product returns its result in its input's type. The
reference proper is float32 throughout (TF32 off) with ``fp8=False,
int_bits=8``: where the configuration quantizes the frozen base, a W8A8
product simulated in float32 (per-row symmetric scales of the activations
and of the weight, as ``ModelConfig.base_quant`` states). The control is
the program's numerics one precision lower: activations in the
configuration's compute type (bf16), the operands of every float product
rounded to float8 e4m3 (one scale a tensor, so that the largest is 448),
and the quantized products in int4 (``fp8=True, int_bits=4``). Rounding
passes the gradient straight through, so the control trains too.

Attention is computed in chunks of the (batch x head) axis, each under
``torch.utils.checkpoint`` when a gradient is recorded, so that the 5184-token
blocks never hold more than one chunk's scores.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0
CHUNK_ELEMS = 2 ** 28  # fp32 scores of one attention chunk: 1 GiB


@dataclasses.dataclass
class Numerics:
    fp8: bool = False
    int_bits: int = 8
    # checkpoint the attention chunks (memory); off when counting the work,
    # which counts no recomputation
    remat: bool = True
    # when a list: every attention call (site, sequences, Lq, Lk, head dim)
    # and quantized product (rows, in, out) is appended to it
    record: Optional[list] = None


NUM = Numerics()


def _ste(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r`` in the forward, the identity's gradient in the backward."""
    return t + (r - t).detach() if t.requires_grad else r


def rnd(t: torch.Tensor) -> torch.Tensor:
    """An operand of a float product, in the current precision."""
    if not NUM.fp8:
        return t
    t32 = t.float()
    s = (t32.detach().abs().amax() / FP8_MAX).clamp(min=1e-30)
    r = (t32.detach() / s).to(torch.float8_e4m3fn).float() * s
    return _ste(t32, r)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x . w^T + b in float32 from the operands as they are, the result in
    x's type (the compute type)."""
    y = F.linear(rnd(x.float()), rnd(w.float()), None if b is None else b.float())
    return y.to(x.dtype)


def quant_rows(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-row quantization of the last axis, returned dequantized:
    s = max(max |t| / qmax, 1e-12), round(t / s) * s."""
    qmax = 2 ** (bits - 1) - 1
    amax = t.detach().abs().amax(-1, keepdim=True)
    # a true division (CUDA divides by a Python scalar through its reciprocal)
    s = (amax / torch.full_like(amax, float(qmax))).clamp(min=1e-12)
    return torch.round(t.detach() / s).clamp(-qmax, qmax) * s


def quant_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 (W4A4 in the control): the rows of x and of the weight
    quantized; dx = dy . dequant(W), the activation's rounding passed
    straight through."""
    xf = x.float()
    if NUM.record is not None:
        NUM.record.append(("int8", xf.numel() // xf.shape[-1], w.shape[1], w.shape[0]))
    xq = _ste(xf, quant_rows(xf, NUM.int_bits))
    wq = quant_rows(w.float(), NUM.int_bits)
    return F.linear(xq, wq, None if b is None else b.float()).to(x.dtype)


def conv2d(x, w, b, **kw):
    return F.conv2d(rnd(x.float()), rnd(w.float()), None if b is None else b.float(),
                    **kw).to(x.dtype)


def conv_transpose2d(x, w, b, **kw):
    return F.conv_transpose2d(rnd(x.float()), rnd(w.float()), None if b is None else b.float(),
                              **kw).to(x.dtype)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, rnd(a.float()), rnd(b.float()))


def _attend(q, k, v, scale, bias):
    logits = einsum("nqd,nkd->nqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    return einsum("nqk,nkd->nqd", torch.softmax(logits, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None, site: str = "") -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over (B, H, L, D) in float32;
    ``bias`` broadcasts to (B, H, Lq, Lk). Chunks of the B*H axis. ``site``
    names the call for the work count ("vit", "enc": the calls the
    program's attention kernels serve)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if NUM.record is not None:
        NUM.record.append(("attn", site, b * h, lq, lk, d))
    if bias is not None:
        bias = bias.float().expand(b, h, lq, lk).reshape(b * h, lq, lk)
    qf, kf, vf = (t.float().reshape(b * h, -1, d) for t in (q, k, v))
    step = max(1, CHUNK_ELEMS // (lq * lk))
    grad = NUM.remat and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(0, b * h, step):
        args = (qf[i:i + step], kf[i:i + step], vf[i:i + step], scale,
                None if bias is None else bias[i:i + step])
        if grad:
            outs.append(torch.utils.checkpoint.checkpoint(_attend, *args, use_reentrant=False))
        else:
            outs.append(_attend(*args))
    return torch.cat(outs).reshape(b, h, lq, d).to(q.dtype)
