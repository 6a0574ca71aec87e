"""Separable-bias (boxRPB) cross-attention of the decoder (a copy of the port's ``ops/rpb_attention.py``).

The bias ``bias[b, h, q, iy*W + ix] = dy[b, q, iy, h] + dx[b, q, ix, h]`` is
built one key chunk (``rows`` grid rows) at a time inside an online-softmax
loop, so no (Lq, H*W) tensor wider than a chunk is ever materialized. Plain
PyTorch: the JAX version was a ``lax.scan``, never a Pallas kernel.

When a gradient is recorded, each chunk runs under ``torch.utils.checkpoint``
(the JAX scan body is a ``jax.checkpoint``): the backward rebuilds a chunk's
logits from the small running (max, sum, acc) instead of keeping every
chunk's probabilities. Exact attention-prob dropout happens in-loop: the
normalizer sums the undropped probabilities while the value accumulator sees
``mask * p / keep``, which is ``dropout(softmax(S)) @ V``. Each chunk's mask
comes from a seed drawn before the chunk, so the replay draws the same mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from . import numerics as num


def _pick_rows(gh: int, gw: int, target: int = 1024) -> int:
    """Largest divisor of gh whose chunk (rows*gw keys) stays <= target."""
    best = gh
    for r in range(1, gh + 1):
        if gh % r == 0 and r * gw <= target:
            best = r
    return best


def _chunk(m, s, acc, qf, k_c, v_c, dy_c, dxt, scale, dropout, rng, seed):
    """One online-softmax step over a key chunk of ``rows`` grid rows."""
    b, h, lq, rows = dy_c.shape
    gw = dxt.shape[-1]
    logits = num.einsum("bhqd,bhkd->bhqk", qf, k_c) * scale
    logits = logits.reshape(b, h, lq, rows, gw) + dy_c[..., None]
    logits = (logits + dxt[:, :, :, None, :]).reshape(b, h, lq, rows * gw)
    m_new = torch.maximum(m, logits.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    s = s * corr + p.sum(-1)
    p_v = p
    if dropout > 0.0:
        keep = 1.0 - dropout
        with rng.fork(seed, p.device):
            p_v = torch.where(rng.keep_mask(p.shape, keep, p.device), p / keep, 0.0)
    acc = acc * corr[..., None] + num.einsum("bhqk,bhkd->bhqd", p_v, v_c)
    return m_new, s, acc


def separable_bias_attention(
    q: torch.Tensor,   # (B, H, Lq, Dh)
    k: torch.Tensor,   # (B, H, GH*GW, Dh)
    v: torch.Tensor,   # (B, H, GH*GW, Dh)
    dy: torch.Tensor,  # (B, Lq, GH, H)
    dx: torch.Tensor,  # (B, Lq, GW, H)
    *,
    grid_hw: Tuple[int, int],
    scale: Optional[float] = None,
    rows: Optional[int] = None,
    dropout: float = 0.0,
    rng=None,
) -> torch.Tensor:
    """``rng`` (a ``models.layers.DropoutRNG``) draws the dropout masks."""
    b, h, lq, dh = q.shape
    gh, gw = grid_hw
    if k.shape[2] != gh * gw:
        raise ValueError(f"k has {k.shape[2]} keys, grid is {gh}x{gw}")
    scale = dh ** -0.5 if scale is None else scale
    rows = _pick_rows(gh, gw) if rows is None else rows
    chunk = rows * gw
    qf = q.float()
    dyt = dy.permute(0, 3, 1, 2).float()  # (B, H, Lq, GH)
    dxt = dx.permute(0, 3, 1, 2).float()  # (B, H, Lq, GW)
    m = torch.full((b, h, lq), float("-inf"), device=q.device)
    s = torch.zeros((b, h, lq), device=q.device)
    acc = torch.zeros((b, h, lq, dh), device=q.device)
    remat = num.NUM.remat and torch.is_grad_enabled()
    for c in range(gh // rows):
        seed = rng.next_seed() if dropout > 0.0 else None
        args = (m, s, acc, qf, k[:, :, c * chunk:(c + 1) * chunk],
                v[:, :, c * chunk:(c + 1) * chunk], dyt[..., c * rows:(c + 1) * rows],
                dxt, scale, dropout, rng, seed)
        if remat:
            m, s, acc = torch.utils.checkpoint.checkpoint(
                _chunk, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            m, s, acc = _chunk(*args)
    return (acc / s[..., None]).to(v.dtype)
