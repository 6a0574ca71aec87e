"""ViTDet backbone (a frozen copy of the port's ViT with its plain paths).

ViT-L/14 at 1008^2 -> 72x72 tokens, 32 blocks of dim 1024 with 16 heads: 28
blocks attend inside 24x24 windows, 4 global blocks over all 5184 tokens.
RoPE is 2D axial in rotate-half layout: the qkv projection's q/k output
channels are permuted (``LoRALinear.out_perm``, applied by the weight maker
to both sides alike) so that each head's channels are (even pair-members |
odd pair-members). Global blocks stretch the 24x24 RoPE grid over 72x72.
Training: stochastic depth per block; every block runs under ``checkpoint``
(memory only: the replay draws the first pass's masks).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import numerics as num
from .attention import merge_heads
from .rope import apply_rope_half, compute_axial_freqs, rope_half_perm
from .windows import window_partition, window_unpartition
from .layers import Conv2d, DropPath, LayerNorm, LoRALinear, Spec, checkpoint

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
    def __init__(self, spec: Spec, input_size: Tuple[int, int], scale_pos: float):
        super().__init__()
        cfg = spec.model
        dim, heads = cfg.vit_dim, cfg.vit_heads
        self.dim, self.heads, self.head_dim = dim, heads, dim // heads
        out_perm = qkv_out_perm(dim, heads) if cfg.vit_use_rope else None
        self.qkv = LoRALinear(dim, 3 * dim, spec, out_perm=out_perm)
        self.proj = LoRALinear(dim, dim, spec)
        # the JAX choice of attention implementation for this block's grid
        if cfg.use_flash_attention and input_size[0] * input_size[1] >= cfg.flash_attention_min_seq:
            self.impl = "pallas"
        elif cfg.use_flash_attention and input_size[0] == cfg.vit_window_size:
            self.impl = "window"
        else:
            self.impl = "xla"
        cos = sin = None
        if cfg.vit_use_rope:
            angles = compute_axial_freqs(
                self.head_dim, input_size[1], input_size[0],
                theta=cfg.vit_rope_theta, scale_pos=scale_pos,
            )
            cos, sin = (torch.tensor(f(angles), device=spec.device) for f in (np.cos, np.sin))
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        return self.proj(self.attend(x)).reshape(b, h, w, self.dim)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, dim) -> the attention output (B, h*w, dim) before the
        output projection."""
        b, l = x.shape[0], x.shape[1] * x.shape[2]
        qkv = self.qkv(x.reshape(b, l, self.dim))
        heads, hd, scale = self.heads, self.head_dim, self.head_dim ** -0.5
        q, k, v = qkv.reshape(b, l, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        if self.rope_cos is not None:
            q = apply_rope_half(q, self.rope_cos, self.rope_sin)
            k = apply_rope_half(k, self.rope_cos, self.rope_sin)
        return merge_heads(num.attention(q, k, v, scale, site="vit"))


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
        self.attn = Attention(spec, input_size, scale_pos)
        self.norm2 = LayerNorm(cfg.vit_dim, spec)
        self.mlp = TimmMlp(cfg.vit_dim, cfg.vit_mlp_hidden, spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.window_size
        b, h, w, c = x.shape
        y = self._attend(x)
        if ws > 0:
            hw = (h, w)
            pad_hw = (h + (ws - h % ws) % ws, w + (ws - w % ws) % ws)
            y = window_unpartition(self.attn.proj(y).reshape(-1, ws, ws, c), ws, pad_hw, hw)
        else:
            y = self.attn.proj(y).reshape(b, h, w, c)
        x = x + self.drop_path(y)
        return x + self.drop_path(self._mlp(x))

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        """norm1, window partition, attention: (B', L, dim) before the output
        projection."""
        y = self.norm1(x)
        if self.window_size > 0:
            y, _ = window_partition(y, self.window_size)
        return self.attn.attend(y)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, R, R) image -> final stride-14 feature map (B, C, R/14, R/14).
    ``pos_embed`` may be sharded, and is gathered at use."""

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

    def _abs_pos(self) -> torch.Tensor:
        cfg = self.spec.model
        feat = cfg.feat_size
        pre = cfg.vit_pretrain_img_size // cfg.patch_size
        grid = self.pos_embed[:, 1:].reshape(1, pre, pre, cfg.vit_dim)
        if cfg.vit_tile_abs_pos:
            reps = (feat + pre - 1) // pre
            return grid.repeat(1, reps, reps, 1)[:, :feat, :feat]
        from .interpolate import resize_bilinear

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
        remat_on = self.training and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, blk, x) if remat_on else blk(x)
        return x.permute(0, 3, 1, 2)
