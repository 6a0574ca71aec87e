"""Core layers (port of ``sam3_lora_tpu/models/layers.py``, eval path).

Naming: every submodule and parameter carries the torch-style name that the
JAX package gives the same module, so ``model.state_dict()`` keys equal the
JAX flat checkpoint keys up to the leaf renames of the weight bridge
(``kernel`` -> ``weight``; ``utils/checkpoint.py``).

Parameters are created empty, in ``ModelConfig.param_dtype`` on
``Spec.device``; ``models/builder.py::init_model`` fills them from a
``torch.Generator`` through each module's ``init_parameters``, which touches
only the module's own parameters. Compute runs in ``ModelConfig.dtype``, with
the fp32 islands of the JAX package (LayerNorm/GroupNorm statistics, softmax).

Training mode (``model.train()``, the JAX modules' ``train=True``) turns on
the JAX package's dropouts. Their masks come from ``Spec.rng``, one
``DropoutRNG`` per model, seeded by the trainer; a block run under
``checkpoint`` draws its masks from a generator re-seeded inside the block
from a seed drawn outside it, so the backward's replay draws the same masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..config import LoRAConfig, ModelConfig

from ..ops import gemm_int8
from ..ops.attention import dot_product_attention, merge_heads, split_heads
from ..ops.long_attention import long_attention_packed
from ..ops.quant import int8_lora_matmul_prequant, int8_matmul, int8_matmul_prequant
from ..ops.rpb_attention import separable_bias_attention


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


def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)


def trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Flax ``truncated_normal(std / .8796)``: a unit normal cut at +-2, so
    the result has standard deviation ``std``."""
    s = std / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=g)


def dropout(x: torch.Tensor, rate: float, spec: Spec, shape=None) -> torch.Tensor:
    """Inverted dropout (the JAX ``jnp.where(mask, x / keep, 0)``), with a
    mask of ``shape`` (default: x's) broadcast over x. The caller decides
    whether it is training."""
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
    only its inputs are saved and the backward replays it. Dropout inside
    draws from a generator re-seeded from a seed drawn here, outside the
    replayed region, so the replay draws the same masks."""
    rng = module.spec.rng
    seed = rng.next_seed()
    device = next(module.parameters()).device

    def run(*a):
        with rng.fork(seed, device):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False
    )


def lecun_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


class LoRALinear(nn.Module):
    """Linear with an optional LoRA branch: y = x W^T + b + (x A^T) B^T * a/r.

    ``weight`` is (out, in) as in ``nn.Linear``; the adapters are ``lora_a``
    (r, in) and ``lora_b`` (out, r), attached by ``add_adapter`` when the
    model's ``LoRAConfig`` targets this module's name (``models/lora.py``).
    ``out_perm`` is the output-channel permutation the JAX module applies at
    apply time; here the weight bridge folds it into ``weight``, ``bias``,
    ``lora_b`` and ``weight_scale`` once, at load, so the forward never
    permutes.

    The int8 tier (``ModelConfig.base_quant``, ``ops/quant.py``) covers the
    layer when ``min(in, out) >= base_quant_min_dim``; the layer then has a
    ``weight_scale`` (out,), the JAX ``kernel_scale``. A float weight is
    quantized on every call (``int8_matmul``); an int8 weight (after
    ``prequantize_model``) runs ``int8_matmul_prequant``, then the bias, then
    the adapter branch. With ``GEMM_LORA_FUSED`` on, an int8 weight with an
    adapter of rank % 8 == 0 (in eval, or with LoRA dropout 0) takes the
    fused product (K5), and the bias is added after the fused sum.
    """

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
        self.zero_init = zero_init
        self.weight = spec.empty(features, in_features)
        mcfg = spec.model
        quant = mcfg.base_quant != "none" and min(in_features, features) >= mcfg.base_quant_min_dim
        self.weight_scale = spec.empty(features, dtype=torch.float32) if quant else None
        self.bias = spec.empty(features) if use_bias else None
        self.out_perm = None if out_perm is None else torch.as_tensor(out_perm)
        self.lora_a: Optional[nn.Parameter] = None
        self.lora_b: Optional[nn.Parameter] = None
        self.scaling = 0.0

    def add_adapter(self, rank: int, alpha: float) -> None:
        self.lora_a = self.spec.empty(rank, self.in_features, dtype=torch.float32)
        self.lora_b = self.spec.empty(self.features, rank, dtype=torch.float32)
        self.scaling = alpha / rank

    def init_parameters(self, g: torch.Generator) -> None:
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            uniform_(self.weight, lecun_bound(self.in_features), g)
        if self.weight_scale is not None:
            nn.init.zeros_(self.weight_scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        if self.lora_a is not None:
            uniform_(self.lora_a, lecun_bound(self.in_features), g)
            nn.init.zeros_(self.lora_b)

    def _fused(self) -> bool:
        lcfg = self.spec.lora
        return (gemm_int8.GEMM_LORA_FUSED and self.weight.dtype == torch.int8
                and self.lora_a is not None and self.spec.model.base_quant == "int8"
                and (not self.training or lcfg is None or lcfg.dropout == 0.0)
                and self.lora_a.shape[0] % 8 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.spec.dtype
        x = x.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.weight_scale is None:
            y = F.linear(x, self.weight.to(dt), bias)
        elif self._fused():
            y = int8_lora_matmul_prequant(x, self.weight, self.weight_scale, self.lora_a,
                                          self.lora_b, self.scaling)
            return y if bias is None else y + bias
        else:
            if self.weight.dtype == torch.int8:
                y = int8_matmul_prequant(x, self.weight, self.weight_scale)
            else:
                y = int8_matmul(x, self.weight)
            if bias is not None:
                y = y + bias
        if self.lora_a is not None:
            xin = x
            if self.training and self.spec.lora is not None:
                xin = dropout(x, self.spec.lora.dropout, self.spec)  # adapter input only
            # adapters are stored fp32; the skinny products run in the compute
            # dtype with fp32 accumulation, as in the JAX module
            h = F.linear(xin, self.lora_a.to(dt))
            delta = F.linear(h.float(), self.lora_b.to(dt).float())
            y = y + (delta * self.scaling).to(y.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 statistics."""

    def __init__(self, dim: int, spec: Spec, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = spec.empty(dim, dtype=torch.float32)
        self.bias = spec.empty(dim, dtype=torch.float32)

    def init_parameters(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

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

    def init_parameters(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """Conv2d over (B, C, H, W), torch weight layout (out, in/groups, kh, kw).
    ``trunc_std`` replaces the default uniform init (the ViT patch embed)."""

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

    def init_parameters(self, g: torch.Generator) -> None:
        if self.trunc_std is not None:
            trunc_normal_(self.weight, self.trunc_std, g)
        else:
            uniform_(self.weight, lecun_bound(self.fan_in), g)
        if self.bias is not None:
            uniform_(self.bias, lecun_bound(self.fan_in), g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.spec.dtype
        return F.conv2d(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            stride=self.stride, padding=self.padding, groups=self.groups,
        )


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention-compatible MHA, batch-first.

    Routing: an unmasked, unbiased self-attention of at least
    ``flash_attention_min_seq`` tokens (the fusion encoder's 5184 image
    tokens) goes to ``long_attention_packed``, with q/k/v straight out of the
    in-projection as packed (B, L, H*dh) operands. The decoder's boxRPB
    cross-attention goes to ``separable_bias_attention``; everything else to
    the plain ``dot_product_attention``.

    Dropout in training, as in the JAX module: on the attention probabilities
    for short sequences; in-loop on the probabilities of the separable-bias
    path; on the attention *output* where both sequences are long (the fused
    path never forms the probabilities).
    """

    def __init__(self, embed_dim: int, num_heads: int, spec: Spec, dropout: float = 0.0):
        super().__init__()
        self.spec = spec
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.in_proj_weight = spec.empty(3 * embed_dim, embed_dim)
        self.in_proj_bias = spec.empty(3 * embed_dim)
        self.out_proj = LoRALinear(embed_dim, embed_dim, spec)

    def init_parameters(self, g: torch.Generator) -> None:
        uniform_(self.in_proj_weight, math.sqrt(1.0 / self.embed_dim), g)
        nn.init.zeros_(self.in_proj_bias)

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
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)
        q = F.linear(query.to(dt), w[:d], b[:d])
        k = F.linear(key.to(dt), w[d:2 * d], b[d:2 * d])
        v = F.linear(value.to(dt), w[2 * d:], b[2 * d:])
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
            out = long_attention_packed(q, k, v, head_dim ** -0.5, head_dim)
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
    """torch nn.Embedding (weight named 'weight'), normal init."""

    def __init__(self, num: int, features: int, spec: Spec, std: float = 1.0):
        super().__init__()
        self.spec, self.std = spec, std
        self.weight = spec.empty(num, features)

    def init_parameters(self, g: torch.Generator) -> None:
        normal_(self.weight, self.std, g)

    def forward(self, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ids is None:
            return self.weight.to(self.spec.dtype)
        return self.weight[ids].to(self.spec.dtype)
