"""Core layers of the PyTorch port against the JAX package (fp32, same
weights through the weight bridge). Tolerance 1e-5: single layers, fp32,
differing only in evaluation order."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import layers as jl
from sam3_lora_tpu.ops import long_attention as la
from sam3_lora_tpu_torch.models import layers as tl
from sam3_lora_tpu_torch.models.lora import apply_lora
from sam3_lora_tpu_torch.ops.long_attention import long_attention_packed
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import assert_close, jax_apply, random_jax_params

TOL = 1e-5
LORA = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1"))


def _specs(**overrides):
    cfg = tiny_model_config(**overrides)
    return jl.Spec(model=cfg, lora=LORA), tl.Spec(model=cfg, lora=LORA)


class _JaxLinear(fnn.Module):
    """Names the LoRALinear "qkv" so the LoRA config targets it."""

    spec: jl.Spec
    perm: tuple

    @fnn.compact
    def __call__(self, x):
        return jl.LoRALinear(12, self.spec, name="qkv", out_perm=self.perm)(x)


def test_lora_linear_with_out_perm_and_adapters():
    jspec, tspec = _specs()
    perm = tuple(np.random.RandomState(0).permutation(12).tolist())
    x = np.random.RandomState(1).standard_normal((2, 5, 8)).astype(np.float32)
    jm = _JaxLinear(jspec, perm)
    params, flat = random_jax_params(jm, jnp.asarray(x))
    assert "qkv.lora_b" in flat
    tm = nn.Module()
    tm.qkv = tl.LoRALinear(8, 12, tspec, out_perm=perm)
    assert apply_lora(tm, LORA) == 1
    load_jax_params(tm, flat)
    assert_close(tm.qkv(torch.from_numpy(x)), jax_apply(jm, params, jnp.asarray(x)),
                 rtol=TOL, atol=TOL)


class _JaxMHA(fnn.Module):
    spec: jl.Spec
    dim: int
    heads: int

    @fnn.compact
    def __call__(self, q, k, v, **kw):
        return jl.MultiHeadAttention(self.dim, self.heads, self.spec, name="attn")(q, k, v, **kw)


def _mha(jspec, tspec, dim, heads, q, k, v, **kw):
    jm = _JaxMHA(jspec, dim, heads)
    jkw = {n: (jnp.asarray(t) if isinstance(t, np.ndarray) else t) for n, t in kw.items()}
    params, flat = random_jax_params(jm, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    ref = jax_apply(jm, params, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    tm = nn.Module()
    tm.attn = tl.MultiHeadAttention(dim, heads, tspec)
    load_jax_params(tm, flat)
    tkw = {n: (torch.from_numpy(t) if isinstance(t, np.ndarray) else t) for n, t in kw.items()}
    return tm.attn(*(torch.from_numpy(t) for t in (q, k, v)), **tkw), ref


def test_mha_padding_and_bias_branch():
    jspec, tspec = _specs()
    rng = np.random.RandomState(2)
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 32)).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[1, 3:] = True
    bias = rng.standard_normal((1, 2, 5, 7)).astype(np.float32)
    out, ref = _mha(jspec, tspec, 32, 2, q, kv, kv, key_padding_mask=kpm, attn_bias=bias)
    assert_close(out, ref, rtol=TOL, atol=TOL)


def test_mha_separable_bias_branch():
    jspec, tspec = _specs()
    rng = np.random.RandomState(3)
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 12, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 5, 3, 2)).astype(np.float32)
    dx = rng.standard_normal((2, 5, 4, 2)).astype(np.float32)
    jm = _JaxMHA(jspec, 32, 2)
    params, flat = random_jax_params(
        jm, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        separable_bias=(jnp.asarray(dy), jnp.asarray(dx), (3, 4)),
    )
    ref = jax_apply(jm, params, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                   separable_bias=(jnp.asarray(dy), jnp.asarray(dx), (3, 4)))
    tm = nn.Module()
    tm.attn = tl.MultiHeadAttention(32, 2, tspec)
    load_jax_params(tm, flat)
    T = torch.from_numpy
    out = tm.attn(T(q), T(kv), T(kv), separable_bias=(T(dy), T(dx), (3, 4)))
    assert_close(out, ref, rtol=TOL, atol=TOL)


def test_mha_long_self_attention_branch(monkeypatch):
    # d = 128 (the JAX long kernel's lane width), 4 heads of 32, L >= the
    # routing threshold: both packages take their long-attention kernel
    monkeypatch.setattr(la, "_FORCE_INTERPRET", True)
    jspec, tspec = _specs(flash_attention_min_seq=16)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 24, 128)).astype(np.float32)
    jax_seen = []
    jax_kernel = la.long_attention_packed
    monkeypatch.setattr(la, "long_attention_packed",
                        lambda *a: jax_seen.append(a[0].shape) or jax_kernel(*a))
    import sam3_lora_tpu_torch.models.layers as port_layers

    seen = []
    monkeypatch.setattr(port_layers, "long_attention_packed",
                        lambda *a: seen.append(a[0].shape) or long_attention_packed(*a))
    out, ref = _mha(jspec, tspec, 128, 4, x, x, x)
    assert seen == [(2, 24, 128)]  # P = 4 heads of 32 straight from the in-projection
    assert set(jax_seen) == {(2, 24, 128)}  # traced at init and at apply
    assert_close(out, ref, rtol=TOL, atol=TOL)


def test_layernorm_and_mlp():
    jspec, tspec = _specs()
    rng = np.random.RandomState(5)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32) * 3 + 1

    class JaxNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = jl.LayerNorm(name="norm")(x)
            return jl.MLP(16, 32, 3, jspec, residual=True, out_norm=True, name="mlp")(x)

    jm = JaxNet()
    params, flat = random_jax_params(jm, jnp.asarray(x))
    tm = nn.Module()
    tm.norm = tl.LayerNorm(32, tspec)
    tm.mlp = tl.MLP(32, 16, 32, 3, tspec, residual=True, out_norm=True)
    load_jax_params(tm, flat)
    out = tm.mlp(tm.norm(torch.from_numpy(x)))
    assert_close(out, jax_apply(jm, params, jnp.asarray(x)), rtol=TOL, atol=TOL)
