"""The port's int8 tier (``ops/quant.py``, ``ops/gemm_int8.py``, the int8
route of ``LoRALinear``, the weight bridge, ``prequantize_model``) against
the JAX package on the CPU, from numpy-seeded inputs.

The quantization follows the XLA expression of ``_quant_lastdim`` as it
runs op by op: s = amax / 127 divided, then t / s. Under ``jax.jit`` XLA
rewrites the division by the constant 127 as a product with 1/127, which
moves s by one fp32 ulp in about 5% of rows (and an int8 value by one step
in about one of 1e6); the bit-for-bit tests therefore call the JAX
functions without ``jit``, as ``prequantize_base`` does.

Tolerances. The quantization (int8 values and scales) and every product of
int8 values (exact sums scaled in fp32) are held equal bit for bit; bf16
outputs of the same fp32 value may differ by one bf16 ulp where a sum taken
in another order lands on the other side of a rounding boundary. Products
of float operands (dx, the adapter branch) differ only in summation order:
1e-5 of their largest entry in fp32, one bf16 ulp of it in bf16. The
port's plain versions of K4/K5/K6 are held to the JAX Pallas kernels (run
in interpret mode) with the shapes and tolerances of
``tests/test_gemm_int8.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import layers as jl
from sam3_lora_tpu.ops import gemm_int8 as jgemm
from sam3_lora_tpu.ops import quant as jquant
from sam3_lora_tpu_torch.models import build_sam3_image_model
from sam3_lora_tpu_torch.models import layers as tl
from sam3_lora_tpu_torch.models.lora import apply_lora, lora_state, save_lora_weights, trainable_parameters
from sam3_lora_tpu_torch.ops import gemm_int8, quant
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params, params_from_jax

from torch_port_helpers import jax_apply, random_jax_params

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 at the top of a binade


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_within_ulp(got, ref, dtype: str, name: str = "") -> None:
    """fp32: equal; bf16: within one ulp of each reference value."""
    g, r = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_array_equal(g, r, err_msg=name)
    else:
        np.testing.assert_array_less(np.abs(g - r), np.abs(r) * BF16_ULP * 1.0001 + 1e-30, err_msg=name)


def _assert_products_close(got, ref, dtype: str, name: str = "") -> None:
    g, r = _np(got), _np(ref)
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(g, r, rtol=0, atol=tol * float(np.abs(r).max()), err_msg=name)


def _rows_with_ties(rng, shape) -> np.ndarray:
    """Random rows, plus a zero row and a row whose scale is exactly 1 with
    entries on .5 ties (2.5, -3.5, 0.5, 1.5, -0.5: round half to even)."""
    x = rng.standard_normal(shape).astype(np.float32).reshape(-1, shape[-1])
    x[0] = 0.0
    x[1] = 0.0
    x[1, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]
    return x.reshape(shape)


@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 128)])
def test_row_quantization_equals_jax_bit_for_bit(shape):
    x = _rows_with_ties(np.random.RandomState(0), shape)
    q, s = gemm_int8.quant_rows(torch.from_numpy(x))
    jq, js = jquant._quant_lastdim(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    q2 = q.reshape(-1, shape[-1])
    assert (q2[0] == 0).all() and q2[1, :6].tolist() == [127, 2, -4, 0, 2, 0]


def test_quantize_weight_equals_jax_bit_for_bit():
    """The port's (N, K) weight against the JAX (K, N) one, with a zero
    output channel and an input channel of .5 ties."""
    w = _rows_with_ties(np.random.RandomState(1), (48, 96))  # (N, K)
    q, s = quant.quantize_weight(torch.from_numpy(w))
    jq, js = jquant.quantize_weight(jnp.asarray(w.T))
    assert q.shape == (48, 96) and s.shape == (48,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])


def _inputs(seed, lead, k, n):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((*lead, n)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("bwd_kernel", [False, True])
def test_int8_matmul_forward_and_dx_match_jax(dtype, prequant, bwd_kernel, monkeypatch):
    """``int8_matmul`` / ``int8_matmul_prequant`` against the JAX custom_vjps.
    With the width gate passed (N = 4096) and ``GEMM_BWD_KERNEL`` on, the
    port's dx runs K6's plain version; the JAX dx stays its XLA product."""
    monkeypatch.setattr(gemm_int8, "GEMM_BWD_KERNEL", bwd_kernel)
    x, w, dy = _inputs(2, (2, 5), 64, 4096)
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True)
    wt = torch.from_numpy(w)
    if prequant:
        wq, ws = quant.quantize_weight(wt)
        y = quant.int8_matmul_prequant(xt, wq, ws)
    else:
        y = quant.int8_matmul(xt, wt)
    calls = gemm_int8.bf16_gemm_wres_nt.launches
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))
    assert gemm_int8.bf16_gemm_wres_nt.launches == calls  # the CPU runs no kernel

    jx, jdy = jnp.asarray(x, JNP[dtype]), jnp.asarray(dy, JNP[dtype])
    if prequant:
        jwq, jws = jquant.quantize_weight(jnp.asarray(w.T))
        fn = lambda v: jquant.int8_matmul_prequant(v, jwq, jws)  # noqa: E731
    else:
        fn = lambda v: jquant.int8_matmul(v, jnp.asarray(w.T))  # noqa: E731
    jy, vjp = jax.vjp(fn, jx)
    (jdx,) = vjp(jdy)
    assert y.dtype == TORCH[dtype] and xt.grad.dtype == TORCH[dtype]
    _assert_within_ulp(y, jy, dtype, "y")
    _assert_products_close(xt.grad, jdx, dtype, "dx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_lora_matmul_forward_and_grads_match_jax(dtype):
    """``int8_lora_matmul_prequant`` forward, dx, d lora_a and d lora_b
    against the JAX custom_vjp (its XLA branch off the TPU)."""
    x, w, dy = _inputs(3, (2, 6), 64, 96)
    rng = np.random.RandomState(4)
    la = (0.1 * rng.standard_normal((8, 64))).astype(np.float32)  # (r, K)
    lb = (0.1 * rng.standard_normal((96, 8))).astype(np.float32)  # (N, r)
    scale = 2.0
    wq, ws = quant.quantize_weight(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True)
    lat, lbt = (torch.from_numpy(a).requires_grad_(True) for a in (la, lb))
    y = quant.int8_lora_matmul_prequant(xt, wq, ws, lat, lbt, scale)
    y.backward(torch.from_numpy(dy).to(TORCH[dtype]))

    jwq, jws = jquant.quantize_weight(jnp.asarray(w.T))
    jy, vjp = jax.vjp(lambda v, a, b: jquant.int8_lora_matmul_prequant(v, jwq, jws, a, b, scale),
                      jnp.asarray(x, JNP[dtype]), jnp.asarray(la.T), jnp.asarray(lb.T))
    jdx, jda, jdb = vjp(jnp.asarray(dy, JNP[dtype]))
    _assert_products_close(y, jy, dtype, "y")  # the adapter branch is a float product
    _assert_products_close(xt.grad, jdx, dtype, "dx")
    # the adapter gradients are fp32 sums of compute-dtype products
    _assert_products_close(lat.grad.T, jda, dtype, "da")
    _assert_products_close(lbt.grad.T, jdb, dtype, "db")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgemm, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jgemm, "GEMM_KERNEL", True)


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (96, 256, 128), (256, 128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_jax_pallas_kernel(interpret, m, k, n, dtype):
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (m, k), JNP[dtype])
    w = jax.random.normal(jax.random.fold_in(key, 1), (k, n), jnp.float32)
    jwq, jws = jax.jit(jquant.quantize_weight)(w)
    ref = jgemm.int8_gemm_wres(x, jwq, jws, out_dtype=JNP[dtype])
    got = gemm_int8.int8_gemm_wres(torch.tensor(np.asarray(x, np.float32)).to(TORCH[dtype]),
                                   torch.from_numpy(np.asarray(jwq).T.copy()),
                                   torch.tensor(np.asarray(jws)[0]))
    err = float(np.abs(_np(got) - _np(ref)).max())
    scale = float(np.abs(_np(ref)).max()) + 1e-6
    assert err / scale < (3e-3 if dtype == "bfloat16" else 1e-6)


def test_k4_plain_zero_rows_quantize_to_zero():
    w = torch.from_numpy(np.random.RandomState(2).standard_normal((128, 128)).astype(np.float32))
    wq, ws = quant.quantize_weight(w)
    out = gemm_int8.int8_gemm_wres(torch.zeros((32, 128)), wq, ws)
    assert (out == 0).all()


def test_k5_plain_matches_jax_pallas_kernel(interpret):
    key = jax.random.PRNGKey(7)
    m, k, n, r = 64, 128, 4736, 32
    x = jax.random.normal(key, (m, k), jnp.float32)
    w = jax.random.normal(jax.random.fold_in(key, 1), (k, n), jnp.float32)
    jwq, jws = jax.jit(jquant.quantize_weight)(w)
    la = jax.random.normal(jax.random.fold_in(key, 2), (k, r), jnp.float32)
    lb = jax.random.normal(jax.random.fold_in(key, 3), (r, n), jnp.float32)
    ref = jgemm.int8_lora_gemm_wres(x, jwq, jws, la, lb, 2.0, out_dtype=jnp.float32,
                                    compute_dtype=jnp.float32)
    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    got = gemm_int8.int8_lora_gemm_wres(T(x), T(np.asarray(jwq).T), T(np.asarray(jws)[0]),
                                        T(np.asarray(la).T), T(np.asarray(lb).T), 2.0)
    sc = float(np.abs(_np(ref)).max()) + 1e-6
    assert float(np.abs(_np(got) - _np(ref)).max()) / sc < 1e-5


def test_k6_plain_matches_jax_pallas_kernel(interpret):
    key = jax.random.PRNGKey(5)
    m, k, n = 64, 256, 128
    dy = jax.random.normal(key, (m, n), jnp.float32)
    w = jax.random.normal(jax.random.fold_in(key, 1), (k, n), jnp.float32)
    jwq, jws = jax.jit(jquant.quantize_weight)(w)
    w_deq = jwq.astype(jnp.float32) * jws
    ref = jgemm.bf16_gemm_wres_nt(dy, w_deq, out_dtype=jnp.float32)
    got = gemm_int8.bf16_gemm_wres_nt(torch.tensor(np.asarray(dy)),
                                      torch.from_numpy(np.asarray(jwq).T.copy()),
                                      torch.tensor(np.asarray(jws)[0]))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)


def test_width_gate_of_the_dx_kernel():
    assert gemm_int8.supported_nt(20736, 1024, 4736)      # fc1's dx
    assert gemm_int8.supported_nt(20736, 4736, 1024)      # fc2's dx
    assert not gemm_int8.supported_nt(20736, 1024, 3072)  # qkv's dx
    assert not gemm_int8.supported_nt(20736, 1024, 1024)  # proj's dx
    assert gemm_int8.GEMM_LORA_FUSED is False and gemm_int8.GEMM_BWD_KERNEL is False


def test_kernel_wrappers_raise_off_the_cpu_and_cuda():
    x = torch.zeros((4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gemm_int8.int8_gemm_wres(x, torch.zeros((8, 32), dtype=torch.int8), torch.ones(8))


class _JaxLinear(fnn.Module):
    """A LoRALinear named "qkv" so the LoRA config targets it."""

    spec: jl.Spec
    perm: tuple

    @fnn.compact
    def __call__(self, x, train=False):
        return jl.LoRALinear(96, self.spec, name="qkv", out_perm=self.perm)(x, train=train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("prequant", [False, True])
def test_lora_linear_int8_matches_jax_module(train, fused, prequant, monkeypatch):
    """The int8 route of ``LoRALinear`` (fp32, with out_perm, rank 8) against
    the JAX module: output, dx and the adapter gradients. JAX takes its
    unfused chain off the TPU; the port's fused route adds the bias after the
    fused sum, which in fp32 is the same to rounding."""
    monkeypatch.setattr(gemm_int8, "GEMM_LORA_FUSED", fused)
    lora = LoRAConfig(rank=8, alpha=16.0, target_modules=("qkv",))
    cfg = tiny_model_config(base_quant="int8", base_quant_min_dim=16)
    perm = tuple(np.random.RandomState(0).permutation(96).tolist())
    x = np.random.RandomState(1).standard_normal((2, 5, 64)).astype(np.float32)
    ct = np.random.RandomState(2).standard_normal((2, 5, 96)).astype(np.float32)
    jm = _JaxLinear(jl.Spec(model=cfg, lora=lora), perm)
    params, flat = random_jax_params(jm, jnp.asarray(x))
    assert flat["qkv.kernel_scale"].shape == (1, 96)
    if prequant:
        params = jquant.prequantize_tree(params, min_dim=16)
    tm = nn.Module()
    tm.qkv = tl.LoRALinear(64, 96, tl.Spec(model=cfg, lora=lora), out_perm=perm)
    apply_lora(tm, lora)
    load_jax_params(tm, flat)
    if prequant:
        assert quant.prequantize_model(tm, 16) == 1 and tm.qkv.weight.dtype == torch.int8
    assert tm.qkv._fused() == (fused and prequant)
    tm.train(train)
    named = trainable_parameters(tm)
    assert [n for n, _ in named] == ["qkv.lora_a", "qkv.lora_b"]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.qkv(xt)
    y.backward(torch.from_numpy(ct))

    def loss(p, v):
        return jnp.sum(jm.apply({"params": p}, v, train=train) * jnp.asarray(ct))

    jy = jax_apply(jm, params, jnp.asarray(x), train=train)
    jgp, jgx = jax.grad(loss, argnums=(0, 1), allow_int=True)(params, jnp.asarray(x))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
    _assert_products_close(xt.grad, jgx, "float32", "dx")
    state = {"qkv.lora_a": tm.qkv.lora_a.grad.numpy().T}
    b = torch.empty_like(tm.qkv.lora_b.grad)
    b[tm.qkv.out_perm] = tm.qkv.lora_b.grad  # back to the JAX channel order
    state["qkv.lora_b"] = b.numpy().T
    for k, g in state.items():
        _assert_products_close(g, jgp["qkv"][k.split(".")[1]], "float32", k)


def test_bridge_loads_int8_trees_and_prequantizes_like_jax():
    """A ``tiny_model_config(base_quant="int8", base_quant_min_dim=16)``
    tree loads strictly before and after the JAX ``prequantize_base``; the
    port's ``prequantize_model`` then equals the JAX one bit for bit (int8
    weights and scales of every quantized layer, out_perm folded). The JAX
    tree and what ``prequantize_base`` made of it come from the stored
    reference (``make_torch_reference.py``). The JAX function leaves the
    scanned ViT blocks' stacked (G, K, N) kernels in fp32 (they quantize per
    call, to the same numbers); the port quantizes them too."""
    import json
    import os

    import make_torch_reference as mk
    from torch_port_helpers import fill_params

    with np.load(os.path.join(os.path.dirname(__file__), "data", "torch_ref_eval_int8.npz")) as d:
        specs = [(tuple(n.split(".")), tuple(s)) for n, s in json.loads(str(d["params"]))]
        quantized = {k[6:]: d[k] for k in d.files if k.startswith("quant/")}
    cfg = mk.case_config("eval_int8")
    flat = fill_params(specs)
    jflat = {**flat, **quantized}
    n_jax = sum(v.dtype == np.int8 for v in jflat.values())
    n_scanned = sum(k.endswith(".kernel") and "scan_blocks_" in k and v.ndim == 3
                    and min(v.shape[1:]) >= 16 for k, v in jflat.items())
    assert n_jax == len(quantized) // 2 > 0

    before = build_sam3_image_model(cfg, lora=mk.LORA)
    assert load_jax_params(before, flat) == len(flat)
    assert quant.prequantize_model(before, 16) == 63
    after = build_sam3_image_model(cfg, lora=mk.LORA)
    assert load_jax_params(after, jflat) == len(jflat)  # strict, int8 leaves included
    assert sum(p.dtype == torch.int8 for p in after.parameters()) == n_jax
    assert quant.prequantize_model(after, 16) == 63 - n_jax == n_scanned > 0
    sd_before, sd_after = before.state_dict(), after.state_dict()
    assert sorted(sd_before) == sorted(sd_after)
    for k in sd_before:
        assert sd_before[k].dtype == sd_after[k].dtype, k
        assert torch.equal(sd_before[k], sd_after[k]), k
    assert params_from_jax(jflat)["transformer.encoder.layers.0.linear1.weight"].dtype == torch.int8


def test_prequantize_model_equals_jax_prequantize_base():
    """``prequantize_model`` on a layer against ``prequantize_base`` of the
    same JAX leaves (op by op, as the JAX trainer runs it)."""
    cfg = tiny_model_config(base_quant="int8", base_quant_min_dim=16)
    rng = np.random.RandomState(5)
    kernel = rng.standard_normal((64, 96)).astype(np.float32)  # JAX (K, N)
    kernel[:, 3] = 0.0
    out = jquant.prequantize_base({("qkv", "kernel"): jnp.asarray(kernel),
                                   ("qkv", "kernel_scale"): jnp.zeros((1, 96))}, min_dim=16)
    tm = nn.Module()
    tm.qkv = tl.LoRALinear(64, 96, tl.Spec(model=cfg))
    load_jax_params(tm, {"qkv.kernel": kernel, "qkv.kernel_scale": np.zeros((1, 96), np.float32)},
                    strict=False)
    assert quant.prequantize_model(tm, 16) == 1
    np.testing.assert_array_equal(tm.qkv.weight.numpy(), np.asarray(out[("qkv", "kernel")]).T)
    np.testing.assert_array_equal(tm.qkv.weight_scale.detach().numpy(), np.asarray(out[("qkv", "kernel_scale")])[0])
    assert quant.prequantize_model(tm, 16) == 0  # once


def test_adapters_never_include_int8_weights_or_scales(tmp_path):
    cfg = tiny_model_config(base_quant="int8", base_quant_min_dim=16)
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1"))
    model = build_sam3_image_model(cfg, lora=lora)
    from sam3_lora_tpu_torch.models import init_model

    init_model(model, torch.Generator().manual_seed(0))
    assert quant.prequantize_model(model, 16) > 0
    names = [n for n, _ in trainable_parameters(model)]
    assert names and all(n.endswith(("lora_a", "lora_b")) for n in names)
    for n, p in model.named_parameters():
        assert p.requires_grad == n.endswith(("lora_a", "lora_b")), n
    assert all(k.endswith(("lora_a", "lora_b")) for k in lora_state(model))
    path = str(tmp_path / "a.npz")
    save_lora_weights(model, path)
    with np.load(path) as d:
        assert all(k.endswith(("lora_a", "lora_b")) for k in d.files)
        assert all(d[k].dtype == np.float32 for k in d.files)


def test_int8_bwd_is_not_ported():
    with pytest.raises(NotImplementedError, match="int8_bwd is not ported yet"):
        build_sam3_image_model(tiny_model_config(base_quant="int8_bwd"))
