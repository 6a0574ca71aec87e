"""SimpleFPN neck (a copy of the port's ``models/neck.py``).

From the stride-14 ViT map (B, C, 72, 72) build four levels at scales
[4, 2, 1, 0.5] -> [288, 144, 72, 36], each projected to d_model by conv1x1 +
conv3x3, with a sine position encoding per level.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .posenc import sine_pos_grid
from . import numerics as num
from .layers import Conv2d, Spec, max_pool_2x2


class ConvTranspose2x2(nn.Module):
    """torch ConvTranspose2d(k=2, s=2); weight (in, out, 2, 2), which may be
    sharded and is gathered at use."""

    def __init__(self, in_ch: int, features: int, spec: Spec):
        super().__init__()
        self.spec = spec
        self.weight = spec.empty(in_ch, features, 2, 2)
        self.bias = spec.empty(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.spec.dtype
        return num.conv_transpose2d(x, self.weight, self.bias, stride=2).to(dt)


class NeckLevel(nn.Module):
    def __init__(self, scale: float, dim: int, spec: Spec):
        super().__init__()
        d = spec.model.d_model
        self.scale = scale
        if scale == 4.0:
            self.dconv_2x2_0 = ConvTranspose2x2(dim, dim // 2, spec)
            self.dconv_2x2_1 = ConvTranspose2x2(dim // 2, dim // 4, spec)
            in_ch = dim // 4
        elif scale == 2.0:
            self.dconv_2x2 = ConvTranspose2x2(dim, dim // 2, spec)
            in_ch = dim // 2
        elif scale in (1.0, 0.5):
            in_ch = dim
        else:
            raise NotImplementedError(f"scale={scale}")
        self.conv_1x1 = Conv2d(in_ch, d, (1, 1), spec)
        self.conv_3x3 = Conv2d(d, d, (3, 3), spec, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == 4.0:
            x = self.dconv_2x2_1(F.gelu(self.dconv_2x2_0(x)))
        elif self.scale == 2.0:
            x = self.dconv_2x2(x)
        elif self.scale == 0.5:
            x = max_pool_2x2(x)
        return self.conv_3x3(self.conv_1x1(x))


class FPNNeck(nn.Module):
    """Returns (features, pos_encodings), high-res -> low-res."""

    def __init__(self, spec: Spec):
        super().__init__()
        cfg = spec.model
        self.d_model = cfg.d_model
        self.convs = nn.ModuleList(
            NeckLevel(s, cfg.vit_dim, spec) for s in cfg.neck_scale_factors
        )

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        outs, poss = [], []
        for level in self.convs:
            cur = level(x)
            outs.append(cur)
            h, w = cur.shape[-2:]
            pos = sine_pos_grid(h, w, num_pos_feats=self.d_model, device=cur.device)
            poss.append(pos[None].expand(cur.shape[0], -1, -1, -1).to(cur.dtype))
        return outs, poss
