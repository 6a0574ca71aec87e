"""Separable-bias (boxRPB) cross-attention of the decoder (port of
``sam3_lora_tpu/ops/rpb_attention.py``, eval path).

The bias ``bias[b, h, q, iy*W + ix] = dy[b, q, iy, h] + dx[b, q, ix, h]`` is
built one key chunk (``rows`` grid rows) at a time inside an online-softmax
loop, so no (Lq, H*W) tensor wider than a chunk is ever materialized. Plain
PyTorch: the JAX version was a ``lax.scan``, never a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pick_rows(gh: int, gw: int, target: int = 1024) -> int:
    """Largest divisor of gh whose chunk (rows*gw keys) stays <= target."""
    best = gh
    for r in range(1, gh + 1):
        if gh % r == 0 and r * gw <= target:
            best = r
    return best


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
) -> torch.Tensor:
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
    for c in range(gh // rows):
        k_c = k[:, :, c * chunk:(c + 1) * chunk].float()
        v_c = v[:, :, c * chunk:(c + 1) * chunk]
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, k_c) * scale
        logits = logits.reshape(b, h, lq, rows, gw)
        logits = logits + dyt[..., c * rows:(c + 1) * rows, None]
        logits = (logits + dxt[:, :, :, None, :]).reshape(b, h, lq, chunk)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v_c.float()
        )
        m = m_new
    return (acc / s[..., None]).to(v.dtype)
