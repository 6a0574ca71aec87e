"""The window routes K1', W-g, W-p and W-qkv of the PyTorch port on the CPU,
where each entry runs its plain versions (forward, and the plain backward
through its autograd Function), against the JAX entries with their Pallas
kernels in interpret mode:

* K1' ``window_attention_packed`` on (N, L, 2D) head pairs;
* W-g ``window_attention``/``window_attention_rope`` with
  ``SAM3_WINDOW_PACKED`` off (``_window_pallas``), against the port's
  ``window_attention[_rope]_grouped`` on (B, H, L, D) views;
* W-p the same wrappers with it on (``_window_pallas_packed``), against
  ``window_attention[_rope]_pair_packed``;
* W-qkv ``window_attention[_rope]_qkv`` on the (N, L, 3*dim) projection;

forward and the gradients of every operand, fp32, at L = 40 (not a multiple
of 64), with the JAX clamp softmax on and off: outputs within 2e-5, gradients
within 2e-5 of each gradient's largest entry. The inputs keep |s| < 10, where
the clamp form equals the port's exact softmax.

Then the routing: the port's ``window_attention``/``window_attention_rope``
take W-p or W-g as the JAX ``_use_packed`` does; ``dot_product_attention
(impl="window")`` on CPU tensors is the plain expression after the RoPE
rotation, as the JAX function off the TPU; and the tiny ViT under each route's
flags matches the JAX ViT under the same flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig as JLoRAConfig
from sam3_lora_tpu.config import tiny_model_config as jtiny
from sam3_lora_tpu.models import vit as jvit
from sam3_lora_tpu.models.layers import Spec as JSpec
from sam3_lora_tpu.ops import attention as jattn
from sam3_lora_tpu.ops import window_attention as jwa
from sam3_lora_tpu.ops import window_qkv as jwq
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.models import vit
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.models.lora import apply_lora
from sam3_lora_tpu_torch.ops import window_attention as wa
from sam3_lora_tpu_torch.ops import window_qkv as wq
from sam3_lora_tpu_torch.ops.attention import dot_product_attention
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import random_jax_params

TOL = 2e-5
B, H, L, D = 2, 4, 40, 32
ROUTES = ("packed", "grouped", "rope_grouped", "pair_packed", "rope_pair_packed", "qkv",
          "rope_qkv")


@pytest.fixture(scope="module", autouse=True)
def jax_backend():
    jnp.zeros(8).block_until_ready()  # the backend starts in the module's setup


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jwa, "_FORCE_INTERPRET", True)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.standard_normal((B, L, 3 * H * D)).astype(np.float32)
    dout = rng.standard_normal((B, L, H * D)).astype(np.float32)
    ang = compute_axial_freqs(D, 5, 8).astype(np.float32)  # (40, D/2)
    return qkv, dout, np.cos(ang), np.sin(ang)


def _split(qkv):
    """(N, L, 3*H*D) -> the (N, H, L, D) q, k, v (jnp or torch)."""
    parts = qkv.reshape(B, L, 3, H, D)
    return [parts[:, :, i].transpose(0, 2, 1, 3) if isinstance(qkv, jax.Array)
            else parts[:, :, i].permute(0, 2, 1, 3) for i in range(3)]


def _pairs(x):
    """(N, L, H*D) -> the JAX packed chain's (N*H/2, L, 2D) head pairs."""
    return x.reshape(B, L, H // 2, 2 * D).transpose(1, 2).reshape(-1, L, 2 * D)


def _jax_route(name, qkv, cos, sin, monkeypatch):
    """The JAX function of one route of qkv -> (N, L, H*D)."""
    scale = D ** -0.5
    rope = (cos, sin) if name.startswith("rope") else ()
    if name.endswith("qkv"):
        entry = jwq.window_attention_rope_qkv if rope else jwq.window_attention_qkv
        return entry(qkv, H, scale, *rope)
    if name == "packed":
        q, k, v = (jnp.transpose(t.reshape(B, L, H // 2, 2 * D), (0, 2, 1, 3)).reshape(-1, L, 2 * D)
                   for t in jnp.split(qkv, 3, axis=-1))
        out = jwa.window_attention_packed(q, k, v, scale)
        return jnp.transpose(out.reshape(B, H // 2, L, 2 * D), (0, 2, 1, 3)).reshape(B, L, H * D)
    monkeypatch.setattr(jwa, "_PACKED", name.endswith("pair_packed"))
    out = (jwa.window_attention_rope if rope else jwa.window_attention)(*_split(qkv), scale, *rope)
    return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, L, H * D)


def _port_route(name, qkv, cos, sin):
    """The port's entry of one route, on the CPU."""
    scale = D ** -0.5
    rope = (cos, sin) if name.startswith("rope") else ()
    if name.endswith("qkv"):
        return getattr(wq, f"window_attention_{name}")(qkv, H, scale, *rope)
    if name == "packed":
        q, k, v = (_pairs(t) for t in qkv.chunk(3, dim=-1))
        out = wa.window_attention_packed(q, k, v, scale)
        return out.reshape(B, H // 2, L, 2 * D).transpose(1, 2).reshape(B, L, H * D)
    out = getattr(wa, f"window_attention_{name}")(*_split(qkv), scale, *rope)
    return out.permute(0, 2, 1, 3).reshape(B, L, H * D)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("name", ROUTES)
def test_route_matches_jax_forward_and_gradients(interpret, monkeypatch, name, clamp):
    monkeypatch.setattr(jwa, "_CLAMP_MAX", clamp)
    qkv, dout, cos, sin = _inputs()
    assert np.abs(np.einsum("nlhd,nmhd->nhlm", *(qkv.reshape(B, L, 3, H, D)[:, :, i]
                                                for i in range(2)))).max() * D ** -0.5 < 10
    jc, js = jnp.asarray(cos), jnp.asarray(sin)
    ref, vjp = jax.vjp(lambda x: _jax_route(name, x, jc, js, monkeypatch), jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = _port_route(name, x, torch.from_numpy(cos), torch.from_numpy(sin))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    ref_grad = np.asarray(ref_grad)
    err = np.abs(x.grad.numpy() - ref_grad).max()
    assert err <= TOL * np.abs(ref_grad).max(), err


@pytest.mark.parametrize("packed,d,pair", [(True, 64, True), (True, 32, False),
                                           (False, 64, False)])
def test_wrappers_route_as_the_jax_gate(monkeypatch, packed, d, pair):
    """``_use_packed``: W-p needs ``_PACKED``, an even head count and
    D % 64 == 0; the CPU still counts no launch."""
    monkeypatch.setattr(wa, "_PACKED", packed)
    taken = []
    for name in ("grouped", "pair_packed", "rope_grouped", "rope_pair_packed"):
        fn = getattr(wa, f"window_attention_{name}")
        monkeypatch.setattr(wa, fn.__name__, lambda *a, _n=name, _f=fn: taken.append(_n) or _f(*a))
    q, k, v = (torch.randn(1, 2, 8, d) for _ in range(3))
    ang = compute_axial_freqs(d, 4, 2).astype(np.float32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    wa.window_attention(q, k, v, 0.1)
    wa.window_attention_rope(q, k, v, 0.1, cos, sin)
    assert taken == (["pair_packed", "rope_pair_packed"] if pair else ["grouped", "rope_grouped"])
    assert all(e.launches == 0 for e in wa.ENTRIES)


def test_dot_product_attention_window_impl_on_the_cpu():
    """impl="window" on CPU tensors: the plain expression after the RoPE
    rotation, as the JAX function gives off the TPU (fp32, 1e-5)."""
    qkv, _, cos, sin = _inputs(1)
    jq, jk, jv = _split(jnp.asarray(qkv))
    ref = jattn.dot_product_attention(jq, jk, jv, impl="window", rope_cos=jnp.asarray(cos),
                                      rope_sin=jnp.asarray(sin))
    q, k, v = _split(torch.from_numpy(qkv))
    out = dot_product_attention(q, k, v, impl="window", rope_cos=torch.from_numpy(cos),
                                rope_sin=torch.from_numpy(sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="no bias"):
        dot_product_attention(q, k, v, impl="window", bias=torch.zeros(1))
    with pytest.raises(ValueError, match="rope tables"):
        dot_product_attention(q, k, v, rope_cos=torch.from_numpy(cos), rope_sin=torch.from_numpy(sin))


VIT_ROUTES = {  # route -> (_PACKED, FUSE_ROPE, QKV_NATIVE, vit_use_rope, the port's entry)
    "k1": (True, True, False, True, (wa, "window_attention_rope_packed_qkv")),
    "qkv": (True, True, True, True, (wq, "window_attention_rope_qkv")),
    "fuse_rope_off": (True, False, False, True, None),
    "packed_off": (False, True, False, True, None),
    "packed_off_fuse_rope_off": (False, False, False, True, None),
    "k1_no_rope": (True, True, False, False, (wa, "window_attention_packed_qkv")),
    "qkv_no_rope": (True, True, True, False, (wq, "window_attention_qkv")),
}


@pytest.mark.parametrize("route", list(VIT_ROUTES))
def test_tiny_vit_route_matches_jax(interpret, monkeypatch, route):
    """The tiny ViT (eval forward and the input's gradient) under each route's
    flags in both packages, the port taking the card's routes on the CPU:
    1e-4, as ``test_torch_models.py``. The grouped chain has no entry on the
    CPU (``dot_product_attention``'s plain expression, as in JAX)."""
    packed, fuse, native, rope, entry = VIT_ROUTES[route]
    for mod in (jwa, wa):
        monkeypatch.setattr(mod, "_PACKED", packed)
        monkeypatch.setattr(mod, "FUSE_ROPE", fuse)
    for mod in (jwq, wq):
        monkeypatch.setattr(mod, "QKV_NATIVE", native)
    monkeypatch.setattr(wa, "_FORCE_INTERPRET", True)
    calls = []
    for mod, name in [v[4] for v in VIT_ROUTES.values() if v[4]]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))

    lora = dict(rank=4, alpha=8.0, target_modules=("qkv", "fc1"))
    jm = jvit.ViT(JSpec(model=jtiny(vit_use_rope=rope), lora=JLoRAConfig(**lora)))
    x = np.random.RandomState(3).standard_normal((2, 3, 56, 56)).astype(np.float32)
    params, flat = random_jax_params(jm, jnp.asarray(x), train=False)
    pm = vit.ViT(Spec(model=tiny_model_config(vit_use_rope=rope), lora=LoRAConfig(**lora)))
    apply_lora(pm, LoRAConfig(**lora))
    load_jax_params(pm, flat)
    pm.eval()
    w = np.random.RandomState(4).standard_normal((2, 32, 4, 4)).astype(np.float32)

    @jax.jit
    def forward_and_grad(v):  # one compile for both
        out, vjp = jax.vjp(lambda u: jm.apply({"params": params}, u), v)
        return out, vjp(jnp.asarray(w))[0]

    ref, ref_grad = forward_and_grad(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pm(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-4)
    n_win = 4 - 2  # tiny: depth 4, global blocks (1, 3)
    assert calls == ([] if entry is None else [entry[1]] * n_win)
