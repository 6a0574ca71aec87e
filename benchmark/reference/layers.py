"""Core layers: a copy of the port's ``models/layers.py`` with its plain
paths, every product through ``numerics.py``.

Naming: every submodule and parameter carries the port's name, so the
benchmark's weights (``benchmark/weights.py``) load into both by name.
Parameters are created empty, in float32; compute runs in the model's
compute type (float32 for the reference), with LayerNorm and GroupNorm
statistics and softmax in float32. Training mode turns on the dropouts;
their masks come from ``Spec.rng``, one ``DropoutRNG`` a model, seeded as
the port's trainer seeds it, so that the reference draws the masks the
program draws. ``checkpoint`` saves memory only: its replay draws from
generators restored to their state at the region's start.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from .config import LoRAConfig, ModelConfig

from . import numerics as num
from .attention import dot_product_attention, merge_heads, split_heads
from .rpb_attention import separable_bias_attention


class DropoutRNG:
    """A model's source of dropout masks: a host generator that hands out
    seeds, and the generator on the activations' device that masks are drawn
    from. Unseeded, it serves no masks (a rate above zero in training then
    raises) and ``fork`` is a no-op."""

    def __init__(self):
        self.host: Optional[torch.Generator] = None
        self.device_generator: Optional[torch.Generator] = None

    def seed(self, seed: int, device) -> None:
        self.host, self.device_generator = self._generators(seed, device)

    @staticmethod
    def _generator(seed: int, device) -> torch.Generator:
        return torch.Generator(device=torch.device(device)).manual_seed(seed)

    def _generators(self, seed: int, device):
        host = torch.Generator().manual_seed(seed)
        seed2 = int(torch.randint(0, 2**62, (1,), generator=host).item())
        return host, self._generator(seed2, device)

    def next_seed(self) -> Optional[int]:
        if self.host is None:
            return None
        return int(torch.randint(0, 2**62, (1,), generator=self.host).item())

    @contextlib.contextmanager
    def fork(self, seed: Optional[int], device):
        """Inside the block, draw seeds and masks from generators seeded with
        ``seed``; the outer streams are left where they were."""
        if seed is None:
            yield
            return
        outer = self.host, self.device_generator
        self.host, self.device_generator = self._generators(seed, device)
        try:
            yield
        finally:
            self.host, self.device_generator = outer

    def state(self):
        """The generators' states (None when unseeded), for ``restored``."""
        if self.host is None:
            return None
        return self.host.get_state(), self.device_generator.get_state()

    @contextlib.contextmanager
    def restored(self, state):
        """Draw seeds and masks from new generators set to ``state``; the
        live ones are left where they are."""
        if state is None:
            yield
            return
        outer = self.host, self.device_generator
        self.host = torch.Generator()
        self.host.set_state(state[0])
        self.device_generator = torch.Generator(device=outer[1].device)
        self.device_generator.set_state(state[1])
        try:
            yield
        finally:
            self.host, self.device_generator = outer

    def keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        g = self.device_generator
        if g is None:
            raise RuntimeError("dropout in training needs a seeded DropoutRNG: "
                               "call model.seed_dropout(seed) first")
        return torch.rand(shape, generator=g, device=device) < keep


@dataclasses.dataclass(frozen=True)
class Spec:
    """Build-time spec threaded through every module; ``rng`` is the model's
    dropout randomness (shared by every module built from this spec)."""

    model: ModelConfig
    lora: Optional[LoRAConfig] = None
    device: Optional[torch.device] = None
    rng: DropoutRNG = dataclasses.field(default_factory=DropoutRNG, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.model.dtype)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.model.param_dtype)

    def empty(self, *shape, dtype: Optional[torch.dtype] = None) -> nn.Parameter:
        return nn.Parameter(
            torch.empty(shape, dtype=dtype or self.param_dtype, device=self.device)
        )








def dropout(x: torch.Tensor, rate: float, spec: Spec, shape=None) -> torch.Tensor:
    """Inverted dropout, ``where(mask, x / keep, 0)``, with a mask of
    ``shape`` (default: x's) broadcast over x. The caller decides whether it
    is training."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = spec.rng.keep_mask(x.shape if shape is None else shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Dropout at ``rate`` in training mode, identity in eval."""

    def __init__(self, rate: float, spec: Spec):
        super().__init__()
        self.rate, self.spec = rate, spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.spec) if self.training else x


class DropPath(nn.Module):
    """Stochastic depth per sample (timm DropPath): one keep draw per row of
    the leading axis, in training mode."""

    def __init__(self, rate: float, spec: Spec):
        super().__init__()
        self.rate, self.spec = rate, spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.spec, shape=(x.shape[0],) + (1,) * (x.ndim - 1))


def checkpoint(module: nn.Module, fn, *args):
    """Run ``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the backward replays it, drawing dropout masks from generators restored
    to their state at the region's start, so it draws the first pass's
    masks."""
    rng = module.spec.rng
    state = rng.state()
    passes = [0]

    def run(*a):
        replay = passes[0] > 0
        passes[0] += 1
        with rng.restored(state) if replay else contextlib.nullcontext():
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False
    )




class LoRALinear(nn.Module):
    """Linear with an optional LoRA branch: y = x W^T + b + (x A^T) B^T * a/r,
    weight (out, in), adapters ``lora_a`` (r, in) and ``lora_b`` (out, r).
    ``out_perm`` is the output-channel order of the weight's rows (the ViT's
    qkv keeps q and k in rotate-half layout). Where the configuration's int8
    tier covers the layer (``min(in, out) >= base_quant_min_dim``), the
    frozen product is the quantized one (``numerics.quant_linear``)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        spec: Spec,
        use_bias: bool = True,
        zero_init: bool = False,
        out_perm: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.spec = spec
        self.in_features, self.features = in_features, features
        self.weight = spec.empty(features, in_features)
        mcfg = spec.model
        self.quant = (mcfg.base_quant != "none"
                      and min(in_features, features) >= mcfg.base_quant_min_dim)
        self.bias = spec.empty(features) if use_bias else None
        self.out_perm = None if out_perm is None else torch.as_tensor(out_perm)
        self.lora_a: Optional[nn.Parameter] = None
        self.lora_b: Optional[nn.Parameter] = None
        self.scaling = 0.0

    def add_adapter(self, rank: int, alpha: float) -> None:
        self.lora_a = self.spec.empty(rank, self.in_features, dtype=torch.float32)
        self.lora_b = self.spec.empty(self.features, rank, dtype=torch.float32)
        self.scaling = alpha / rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.spec.dtype)
        delta = None
        if self.lora_a is not None:
            xin = x
            if self.training and self.spec.lora is not None:
                xin = dropout(x, self.spec.lora.dropout, self.spec)  # adapter input only
            delta = num.linear(num.linear(xin, self.lora_a), self.lora_b) * self.scaling
        if self.quant:
            y = num.quant_linear(x, self.weight, self.bias)
        else:
            y = num.linear(x, self.weight, self.bias)
        return y if delta is None else y + delta


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 statistics."""

    def __init__(self, dim: int, spec: Spec, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = spec.empty(dim, dtype=torch.float32)
        self.bias = spec.empty(dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """torch GroupNorm over (B, C, H, W) with fp32 statistics."""

    def __init__(self, num_groups: int, channels: int, spec: Spec, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = spec.empty(channels, dtype=torch.float32)
        self.bias = spec.empty(channels, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """Conv2d over (B, C, H, W), torch weight layout (out, in/groups, kh, kw).
    ``trunc_std`` replaces the default uniform init (the ViT patch embed).
    ``weight`` may be sharded, and is gathered at use."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel_size: Tuple[int, int],
        spec: Spec,
        stride: int = 1,
        padding: int = 0,
        use_bias: bool = True,
        groups: int = 1,
        trunc_std: Optional[float] = None,
    ):
        super().__init__()
        self.spec = spec
        self.stride, self.padding, self.groups = stride, padding, groups
        self.trunc_std = trunc_std
        kh, kw = kernel_size
        self.fan_in = (in_ch // groups) * kh * kw
        self.weight = spec.empty(features, in_ch // groups, kh, kw)
        self.bias = spec.empty(features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.spec.dtype
        return num.conv2d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, groups=self.groups).to(dt)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention-compatible MHA, batch-first: q/k/v from one
    in-projection, then ``numerics.attention`` (an unmasked self-attention
    of at least ``flash_attention_min_seq`` tokens, the fusion encoder's
    image tokens, with dropout on its output, as the port's long-attention
    route), the chunked separable-bias attention for the decoder's boxRPB,
    or ``dot_product_attention``, with dropout on the probabilities."""

    def __init__(self, embed_dim: int, num_heads: int, spec: Spec, dropout: float = 0.0):
        super().__init__()
        self.spec = spec
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.in_proj_weight = spec.empty(3 * embed_dim, embed_dim)
        self.in_proj_bias = spec.empty(3 * embed_dim)
        self.out_proj = LoRALinear(embed_dim, embed_dim, spec)

    def forward(
        self,
        query: torch.Tensor,  # (B, Lq, D)
        key: torch.Tensor,
        value: torch.Tensor,
        *,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, Lk) True = pad
        attn_bias: Optional[torch.Tensor] = None,  # additive (B|1, H|1, Lq, Lk)
        separable_bias=None,  # (dy (B,Lq,GH,H), dx (B,Lq,GW,H), (GH, GW))
    ) -> torch.Tensor:
        d, dt = self.embed_dim, self.spec.dtype
        w = self.in_proj_weight
        b = self.in_proj_bias
        q = num.linear(query, w[:d], b[:d])
        k = num.linear(key, w[d:2 * d], b[d:2 * d])
        v = num.linear(value, w[2 * d:], b[2 * d:])
        head_dim = d // self.num_heads
        mcfg = self.spec.model
        lq, lk = q.shape[1], k.shape[1]
        drop = self.dropout if self.training else 0.0
        long_seq = (mcfg.use_flash_attention and lq >= mcfg.flash_attention_min_seq
                    and lk >= mcfg.flash_attention_min_seq)
        if (
            long_seq
            and lk == lq
            and attn_bias is None
            and key_padding_mask is None
            and separable_bias is None
        ):
            out = merge_heads(num.attention(*(split_heads(t, self.num_heads) for t in (q, k, v)),
                                            head_dim ** -0.5, site="enc"))
            return self.out_proj(dropout(out, drop, self.spec))
        qh, kh, vh = (split_heads(t, self.num_heads) for t in (q, k, v))
        if separable_bias is not None:
            dy, dx, grid_hw = separable_bias
            out = separable_bias_attention(qh, kh, vh, dy, dx, grid_hw=grid_hw,
                                           dropout=drop, rng=self.spec.rng)
        elif long_seq:
            out = dot_product_attention(
                qh, kh, vh, bias=attn_bias, key_padding_mask=key_padding_mask
            )
            out = dropout(out, drop, self.spec)
        else:
            out = dot_product_attention(
                qh, kh, vh, bias=attn_bias, key_padding_mask=key_padding_mask,
                dropout=drop, rng=self.spec.rng,
            )
        return self.out_proj(merge_heads(out))


class MLP(nn.Module):
    """Reference model_misc.MLP: relu between layers, dropout on the hidden
    activations in training, optional residual and output LayerNorm."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        output_dim: int,
        num_layers: int,
        spec: Spec,
        dropout: float = 0.0,
        residual: bool = False,
        out_norm: bool = False,
        zero_init_last: bool = False,
    ):
        super().__init__()
        self.drop = Dropout(dropout, spec)
        dims_in = [in_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            LoRALinear(i, o, spec, zero_init=zero_init_last and n == num_layers - 1)
            for n, (i, o) in enumerate(zip(dims_in, dims_out))
        )
        self.residual = residual
        self.out_norm = LayerNorm(output_dim, spec) if out_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.drop(F.relu(x))
        if self.residual:
            x = x + orig
        if self.out_norm is not None:
            x = self.out_norm(x)
        return x


class Embedding(nn.Module):
    """torch nn.Embedding (weight named 'weight'), normal init. ``weight``
    may be sharded, and is gathered at use."""

    def __init__(self, num: int, features: int, spec: Spec, std: float = 1.0):
        super().__init__()
        self.spec, self.std = spec, std
        self.weight = spec.empty(num, features)

    def forward(self, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ids is None:
            return self.weight.to(self.spec.dtype)
        return self.weight[ids].to(self.spec.dtype)
