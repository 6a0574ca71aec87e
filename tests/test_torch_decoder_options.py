"""Two decoder options of the port against the JAX package's
``TransformerDecoder`` on the tiny config (fp32, the same seeded weights and
inputs): ``box_rpb="none"`` (no ``rpb`` module, no bias) and
``dec_separable_bias=False`` (the dense (B, heads, L, HW) boxRPB bias, with
the presence row's zero bias prepended, through the plain attention), each
without and with DAC query doubling (eval mode). Tolerance 1e-4 absolute
and relative, as ``test_torch_models.py::test_decoder``.

The JAX results are stored in ``tests/data/torch_ref_decoder_options.npz``;
``test_reference_is_current`` (slow: it jits the JAX decoder) recomputes
them. Rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_decoder_options.py``.

On the port alone: the dense oracle equals the separable route on the same
weights (1e-5: the same sums, chunked), and ``rpb_dense_bias`` equals the
JAX function exactly."""

import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.models import decoder
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import fill_params, load_reference, save_reference

TOL = 1e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_ref_decoder_options.npz")
OPTIONS = {"none": dict(box_rpb="none"), "dense": dict(dec_separable_bias=False)}
FIELDS = ("hs", "reference_boxes", "pred_coords", "presence_logits", "presence_feats")
FEAT = tc.tiny_model_config().feat_size


def inputs():
    rng = np.random.RandomState(7)
    d = tc.tiny_model_config().d_model
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(2, FEAT * FEAT, d), f(2, FEAT * FEAT, d), f(2, 6, d),
            np.array([[False] * 3 + [True] * 3, [False] * 6]))


def jax_reference():
    """-> ({option: specs}, {option/field: the JAX decoder's output}), eval
    and DAC."""
    import jax.numpy as jnp

    from sam3_lora_tpu.config import tiny_model_config
    from sam3_lora_tpu.models import decoder as jdec
    from sam3_lora_tpu.models.layers import Spec as JSpec
    from torch_port_helpers import jax_apply, random_jax_params

    args = tuple(jnp.asarray(a) for a in inputs()) + ((FEAT, FEAT),)
    specs, res = {}, {}
    for name, opt in OPTIONS.items():
        jm = jdec.TransformerDecoder(JSpec(model=tiny_model_config(**opt), lora=None))
        params, flat = random_jax_params(jm, *args)
        specs[name] = [(tuple(k.split(".")), v.shape) for k, v in flat.items()]
        for dac in (False, True):
            out = jax_apply(jm, params, *args, apply_dac=dac)
            res.update({f"{name}/{int(dac)}/{k}": np.asarray(getattr(out, k)) for k in FIELDS})
    return specs, res


def port_decoder(name, specs) -> decoder.TransformerDecoder:
    cfg = tc.tiny_model_config(**OPTIONS[name])
    m = decoder.TransformerDecoder(Spec(model=cfg, lora=None, device=torch.device("cpu")))
    load_jax_params(m, fill_params(specs))
    return m.eval()


@torch.no_grad()
def port_results(name, specs):
    m = port_decoder(name, specs)
    args = tuple(torch.from_numpy(a) for a in inputs()) + ((FEAT, FEAT),)
    res = {}
    for dac in (False, True):
        out = m(*args, apply_dac=dac)
        res.update({f"{name}/{int(dac)}/{k}": getattr(out, k).numpy() for k in FIELDS})
    return res


def _load():
    specs, arrays = load_reference(REF)
    n = int(arrays.pop("n_none_params"))
    return {"none": specs[:n], "dense": specs[n:]}, arrays


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_decoder_option_matches_jax(name):
    specs, want = _load()
    got = port_results(name, specs[name])
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=TOL, atol=TOL, err_msg=k)
    m = port_decoder(name, specs[name])
    assert (m.rpb is None) == (name == "none")


def test_dense_oracle_equals_separable_route():
    specs, _ = _load()
    dense = port_decoder("dense", specs["dense"])
    sep = decoder.TransformerDecoder(Spec(model=tc.tiny_model_config(), lora=None,
                                          device=torch.device("cpu"))).eval()
    sep.load_state_dict(dense.state_dict())
    args = tuple(torch.from_numpy(a) for a in inputs()) + ((FEAT, FEAT),)
    with torch.no_grad():
        a, b = dense(*args), sep(*args)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(a, k).numpy(), getattr(b, k).numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_chip_smoke_decoder_options_on_the_cpu():
    """chip_smoke's full-width check, at the tiny width in fp32 on the CPU:
    the oracle within 1e-5 of the separable route, no-RPB outputs finite."""
    import chip_smoke

    worst, finite = chip_smoke.decoder_options(tc.tiny_model_config(), torch.device("cpu"),
                                               torch.Generator().manual_seed(0))
    assert worst <= 1e-5 and finite


def test_rpb_dense_bias_matches_jax():
    import jax.numpy as jnp

    from sam3_lora_tpu.models import decoder as jdec

    rng = np.random.RandomState(3)
    dy, dx = rng.standard_normal((2, 5, 4, 3)), rng.standard_normal((2, 5, 6, 3))
    dy, dx = dy.astype(np.float32), dx.astype(np.float32)
    got = decoder.rpb_dense_bias(torch.from_numpy(dy), torch.from_numpy(dx))
    assert got.shape == (2, 3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdec.rpb_dense_bias(jnp.asarray(dy),
                                                                              jnp.asarray(dx))))


def test_reference_is_current():
    specs, live = jax_reference()
    stored_specs, want = _load()
    for name in OPTIONS:
        assert [(".".join(p), tuple(s)) for p, s in stored_specs[name]] == \
            [(".".join(p), tuple(s)) for p, s in specs[name]]
        got = port_results(name, specs[name])
        for k, v in got.items():
            np.testing.assert_array_equal(live[k], want[k], err_msg=k)
            np.testing.assert_allclose(v, live[k], rtol=TOL, atol=TOL, err_msg=k)


if __name__ == "__main__":
    specs, res = jax_reference()
    res["n_none_params"] = np.asarray(len(specs["none"]))
    print(save_reference(REF, specs["none"] + specs["dense"], res))
