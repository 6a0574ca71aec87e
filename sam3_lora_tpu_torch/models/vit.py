"""ViTDet backbone (port of ``sam3_lora_tpu/models/vit.py``, flat blocks).

ViT-L/14 at 1008^2 -> 72x72 tokens, 32 blocks of dim 1024 with 16 heads:
28 blocks attend inside 24x24 windows (``window_attention_rope_packed``), 4
global blocks over all 5184 tokens (``long_attention_rope_packed``). Both
read q/k/v as packed (N, L, H*dh) views of the qkv projection output, with no
relayout, and write the (N, L, H*dh) layout the output projection takes.

RoPE is 2D axial in rotate-half layout: the qkv projection's q/k output
channels were permuted at load (``LoRALinear.out_perm``) so each head's
channels are (even pair-members | odd pair-members). Global blocks stretch
the 24x24 RoPE grid over 72x72 (``scale_pos`` = 24/72).

Training: stochastic depth per block (rates linear in depth up to
``vit_drop_path_rate``) on both residual branches, and the ``windows_only``
remat policy of the JAX ViT: the windowed blocks run under ``checkpoint``
(the backward replays them from their inputs), the global blocks keep their
activations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.long_attention import long_attention_rope_packed_qkv
from ..ops.rope import compute_axial_freqs, rope_half_perm
from ..ops.window_attention import window_attention_rope_packed_qkv
from ..ops.windows import window_partition, window_unpartition
from .layers import Conv2d, DropPath, LayerNorm, LoRALinear, Spec, checkpoint, trunc_normal_


def qkv_out_perm(dim: int, heads: int) -> np.ndarray:
    """Output-channel permutation of the qkv projection that puts every
    head's q and k channels in rotate-half layout (v is untouched)."""
    head_dim = dim // heads
    per_head = np.concatenate([rope_half_perm(head_dim) + h * head_dim for h in range(heads)])
    return np.concatenate([per_head, dim + per_head, 2 * dim + np.arange(dim)])


class PatchEmbed(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        p = cfg.patch_size
        # no bias (bias_patch_embed=False in the reference builder)
        self.proj = Conv2d(3, cfg.vit_dim, (p, p), spec, stride=p, use_bias=False,
                           trunc_std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, H/p, W/p, C)."""
        return self.proj(x).permute(0, 2, 3, 1)


class Attention(nn.Module):
    def __init__(self, spec: Spec, input_size: Tuple[int, int], scale_pos: float, window: bool):
        super().__init__()
        cfg = spec.model
        if not cfg.vit_use_rope:
            raise NotImplementedError("vit_use_rope=False is not ported yet")
        dim, heads = cfg.vit_dim, cfg.vit_heads
        self.dim, self.head_dim, self.window = dim, dim // heads, window
        self.qkv = LoRALinear(dim, 3 * dim, spec, out_perm=qkv_out_perm(dim, heads))
        self.proj = LoRALinear(dim, dim, spec)
        angles = compute_axial_freqs(
            self.head_dim, input_size[1], input_size[0],
            theta=cfg.vit_rope_theta, scale_pos=scale_pos,
        )
        self.register_buffer("rope_cos", torch.tensor(np.cos(angles), device=spec.device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.tensor(np.sin(angles), device=spec.device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        d = self.dim
        qkv = self.qkv(x.reshape(b, h * w, d))
        # the packed qkv goes in whole, so its gradient comes back as one tensor
        scale = self.head_dim ** -0.5
        if self.window:
            out = window_attention_rope_packed_qkv(qkv, scale, self.rope_cos, self.rope_sin)
        else:
            out = long_attention_rope_packed_qkv(qkv, scale, self.head_dim, self.rope_cos,
                                                 self.rope_sin)
        return self.proj(out).reshape(b, h, w, d)


class TimmMlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, spec: Spec):
        super().__init__()
        self.fc1 = LoRALinear(dim, hidden, spec)
        self.fc2 = LoRALinear(hidden, dim, spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, spec: Spec, window_size: int, drop_path: float = 0.0):
        super().__init__()
        cfg = spec.model
        feat = cfg.feat_size
        self.spec = spec
        self.window_size = window_size
        self.drop_path = DropPath(drop_path, spec)
        if window_size > 0:
            input_size, scale_pos = (window_size, window_size), 1.0
        else:
            input_size = (feat, feat)
            scale_pos = cfg.vit_window_size / feat if cfg.vit_rope_interp else 1.0
        self.norm1 = LayerNorm(cfg.vit_dim, spec)
        self.attn = Attention(spec, input_size, scale_pos, window=window_size > 0)
        self.norm2 = LayerNorm(cfg.vit_dim, spec)
        self.mlp = TimmMlp(cfg.vit_dim, cfg.vit_mlp_hidden, spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.window_size
        y = self.norm1(x)
        if ws > 0:
            hw = (y.shape[1], y.shape[2])
            y, pad_hw = window_partition(y, ws)
        y = self.attn(y)
        if ws > 0:
            y = window_unpartition(y, ws, pad_hw, hw)
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ViT(nn.Module):
    """(B, 3, R, R) image -> final stride-14 feature map (B, C, R/14, R/14)."""

    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.spec = spec
        self.patch_embed = PatchEmbed(spec)
        self.pos_embed = None
        if cfg.vit_use_abs_pos:
            pre = cfg.vit_pretrain_img_size // cfg.patch_size
            self.pos_embed = spec.empty(1, pre * pre + 1, cfg.vit_dim)  # +1 cls slot
        self.ln_pre = LayerNorm(cfg.vit_dim, spec) if cfg.vit_ln_pre else None
        rates = np.linspace(0.0, cfg.vit_drop_path_rate, cfg.vit_depth)
        self.blocks = nn.ModuleList(
            Block(spec, 0 if i in cfg.vit_global_blocks else cfg.vit_window_size,
                  float(rates[i]))
            for i in range(cfg.vit_depth)
        )

    def init_parameters(self, g: torch.Generator) -> None:
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, 0.02, g)

    def _abs_pos(self) -> torch.Tensor:
        cfg = self.spec.model
        feat = cfg.feat_size
        pre = cfg.vit_pretrain_img_size // cfg.patch_size
        grid = self.pos_embed[:, 1:].reshape(1, pre, pre, cfg.vit_dim)
        if cfg.vit_tile_abs_pos:
            reps = (feat + pre - 1) // pre
            return grid.repeat(1, reps, reps, 1)[:, :feat, :feat]
        from ..ops.interpolate import resize_bilinear

        return resize_bilinear(grid.permute(0, 3, 1, 2), (feat, feat)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.spec.model
        dt = self.spec.dtype
        if x.dtype == torch.uint8:
            # exactly (u/255 - 0.5)/0.5 for the production mean = std = 0.5
            x = (x.float() * (2.0 / 255.0) - 1.0).to(dt)
        x = self.patch_embed(x)  # (B, h, w, C)
        if self.pos_embed is not None:
            x = x + self._abs_pos().to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        remat = self.training and torch.is_grad_enabled()
        if remat and cfg.vit_remat_policy != "windows_only":
            raise NotImplementedError(
                f"vit_remat_policy={cfg.vit_remat_policy!r} is not ported; use 'windows_only'")
        for blk in self.blocks:
            x = checkpoint(blk, blk, x) if remat and blk.window_size > 0 else blk(x)
        return x.permute(0, 3, 1, 2)
