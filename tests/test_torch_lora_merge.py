"""The port's ``merge_lora_into_base`` and ``lora_module_names``
(``sam3_lora_tpu_torch/models/lora.py``) against the JAX package's, on the
tiny config with adapters on qkv, fc1, fc2, linear1 and linear2 and the
seeded weights of ``tests/data/torch_ref_train.npz``'s specs (``lora_b``
non-zero):

* the merged base equals JAX's ``merge_lora_into_base`` of the same tree,
  through the bridge (``base_params_to_jax``, which unfolds the qkv
  ``out_perm``): within 1e-6, fp32 sums in another order (B A against
  A B); no adapter is left;
* the merged eval forward matches the adapted one within the slice tests'
  fp32 tolerance (2e-4), where the adapters move it by more;
* zero-B adapters: the merge leaves every weight and the forward bit for
  bit as they were (``tests/test_model.py``'s zero-init anchor);
* an int8 (prequantized) base is refused before anything changes; a float
  engine merged and saved (``save_base_checkpoint``), then loaded by an
  int8 engine (``base_checkpoint=``), runs K4's route on every adapted
  layer, not K5's (the entries counted on the CPU, as chip_smoke counts
  them on the card);
* ``lora_module_names`` equals JAX's for the target sets of
  ``tests/test_model.py::TestLoRA`` and the processors', scanned and not
  (JAX's stored in ``tests/data/torch_ref_lora_names.json``;
  ``test_stored_names_are_current`` recomputes them; rewrite:
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_lora_merge.py``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sam3_lora_tpu.config import LoRAConfig as JLoRAConfig
from sam3_lora_tpu.config import tiny_model_config as jax_tiny
from sam3_lora_tpu.models import build_sam3_image_model as build_jax
from sam3_lora_tpu.models.builder import dummy_batch as jax_dummy_batch
from sam3_lora_tpu.models.lora import lora_module_names as jax_lora_module_names
from sam3_lora_tpu.models.lora import merge_lora_into_base as jax_merge
from sam3_lora_tpu_torch.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models import Batch, GeoPrompt, build_sam3_image_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import (
    lora_module_names, merge_lora_into_base, save_lora_weights)
from sam3_lora_tpu_torch.ops import gemm_int8
from sam3_lora_tpu_torch.ops.quant import prequantize_model
from sam3_lora_tpu_torch.utils.checkpoint import (
    base_params_to_jax, load_jax_params, save_base_checkpoint)

from test_torch_reference import LORA, _load
from torch_port_helpers import fill_params

TOL = 2e-4  # fp32 through the whole tiny model (test_torch_slice.py)
WEIGHT_TOL = 1e-6


@pytest.fixture(scope="module")
def weights():
    specs = [(tuple(n.split(".")), tuple(s))
             for n, s in json.loads(str(_load("train")["params"]))]
    return specs, fill_params(specs)


def adapted_model(flat, cfg=None):
    model = build_sam3_image_model(cfg or tiny_model_config(), lora=LORA)
    load_jax_params(model, flat)
    return model


def batch(cfg, n=2, seed=0):
    rng = np.random.RandomState(seed)
    r = cfg.img_size
    ids = np.zeros((n, cfg.text_context_length), np.int64)
    ids[:, :4] = [49406, 320, 1125, 49407]
    return Batch(images=torch.from_numpy(rng.standard_normal((1, 3, r, r)).astype(np.float32)),
                 token_ids=torch.from_numpy(ids), img_ids=torch.zeros((n,), dtype=torch.long),
                 geo=GeoPrompt.empty(n, cfg.max_prompt_boxes))


KEYS = ("pred_logits", "pred_boxes", "pred_masks", "presence_logit_dec")


@torch.no_grad()
def forward(model, b):
    out = model(b)
    return {k: out[k].clone() for k in KEYS}


def test_merged_weights_match_jax(weights):
    specs, flat = weights
    tree = traverse_util.unflatten_dict({p: jnp.asarray(flat[".".join(p)]) for p, _ in specs})
    want = {".".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax_merge(tree, LORA)).items()}
    model = adapted_model(flat)
    n_adapters = sum(n.endswith(".lora_a") for n, _ in model.named_parameters())
    assert merge_lora_into_base(model) == n_adapters > 0
    assert not any(n.endswith(("lora_a", "lora_b")) for n, _ in model.named_parameters())
    got = base_params_to_jax(model)
    assert sorted(got) == sorted(want)
    qkv = [k for k in want if k.endswith("attn.qkv.kernel")]
    assert qkv
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=WEIGHT_TOL, atol=WEIGHT_TOL, err_msg=k)
    # the qkv kernels moved (their adapters are live), so the check pins out_perm
    for k in qkv:
        assert not np.allclose(want[k], flat[k], atol=1e-3), k


def test_merged_forward_matches_adapted(weights):
    _, flat = weights
    cfg = tiny_model_config()
    model, b = adapted_model(flat), batch(cfg)
    adapted = forward(model, b)
    bare = {k: v for k, v in flat.items() if not k.endswith(("lora_a", "lora_b"))}
    plain = build_sam3_image_model(cfg)
    load_jax_params(plain, bare)
    without = forward(plain, b)
    merge_lora_into_base(model)
    merged = forward(model, b)
    for k in KEYS:
        assert (adapted[k] - without[k]).abs().max() > 10 * TOL, k  # the adapters matter
        torch.testing.assert_close(merged[k], adapted[k], rtol=TOL, atol=TOL, msg=k)


def test_zero_b_merge_changes_nothing(weights):
    _, flat = weights
    zero = {k: (np.zeros_like(v) if k.endswith("lora_b") else v) for k, v in flat.items()}
    cfg = tiny_model_config()
    model, b = adapted_model(zero), batch(cfg)
    before = {k: p.clone() for k, p in model.named_parameters() if not k.endswith(("lora_a",
                                                                                   "lora_b"))}
    adapted = forward(model, b)
    assert merge_lora_into_base(model) > 0
    after = dict(model.named_parameters())
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], p) for k, p in before.items())
    merged = forward(model, b)
    assert all(torch.equal(merged[k], adapted[k]) for k in KEYS)


def test_merge_refuses_an_int8_base(weights):
    _, flat = weights
    cfg = tiny_model_config(base_quant="int8", base_quant_min_dim=16)
    model = adapted_model(flat, cfg)
    prequantize_model(model, cfg.base_quant_min_dim)
    n_lora = sum(n.endswith("lora_a") for n, _ in model.named_parameters())
    with pytest.raises(ValueError, match="int8"):
        merge_lora_into_base(model)
    assert sum(n.endswith("lora_a") for n, _ in model.named_parameters()) == n_lora > 0


@pytest.fixture
def counted(monkeypatch):
    """K4's and K5's entries counted on the CPU (their plain versions run)."""
    calls = {}
    for entry in (gemm_int8.int8_gemm_wres, gemm_int8.int8_lora_gemm_wres):
        plain = getattr(gemm_int8, entry.__name__ + "_plain")

        def count(*a, _name=entry.__name__, _plain=plain, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)

        monkeypatch.setattr(gemm_int8, entry.__name__, count)
    monkeypatch.setattr(gemm_int8, "GEMM_LORA_FUSED", True)
    return calls


def test_engine_merges_before_the_int8_tier(weights, tmp_path, counted):
    """Adapted: the ViT's qkv, fc1 and fc2 take K5, the other quantized
    layers K4. The same adapters merged into a float engine's base, saved,
    and loaded by an int8 engine, which quantizes it: every one of those
    layers K4, none K5."""
    _, flat = weights
    cfg = tiny_model_config(base_quant="int8", base_quant_min_dim=32)
    lora = LoRAConfig(rank=8, alpha=16.0, target_modules=("qkv", "fc1", "fc2"))  # K5: rank % 8
    path = str(tmp_path / "lora.npz")
    src = build_sam3_image_model(tiny_model_config(), lora=lora)
    g = torch.Generator().manual_seed(3)
    for m in src.modules():
        if isinstance(m, LoRALinear) and m.lora_a is not None:
            m.lora_a.data.normal_(0, 0.1, generator=g)
            m.lora_b.data.normal_(0, 0.1, generator=g)
    save_lora_weights(src, path)
    image = np.random.RandomState(1).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    float_engine = SAM3LoRAInference(tiny_model_config(), lora, weights=path, device="cpu")
    merge_lora_into_base(float_engine.model)
    base = str(tmp_path / "merged_base.npz")
    save_base_checkpoint(float_engine.model, base)
    runs = {}
    for merged, kw in ((False, dict(lora_cfg=lora, weights=path)),
                       (True, dict(base_checkpoint=base))):
        engine = SAM3LoRAInference(cfg, device="cpu", **kw)
        counted.clear()
        runs[merged] = (engine.predict(image, ["crack"], threshold=0.0), dict(counted))
    k4, k5 = runs[False][1]["int8_gemm_wres"], runs[False][1]["int8_lora_gemm_wres"]
    assert k5 == 3 * cfg.vit_depth and k4 > 0
    assert runs[True][1] == {"int8_gemm_wres": k4 + k5}
    a, m = runs[False][0][0], runs[True][0][0]
    assert a["num_detections"] == m["num_detections"] == cfg.num_queries
    # int8 quantization of W against of W + dW: the scores agree loosely
    np.testing.assert_allclose(m["scores"], a["scores"], atol=5e-2)


def _jax_names(cfg, lcfg):
    model = build_jax(cfg, lora=lcfg)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jax_dummy_batch(cfg), train=False))["params"]
    return jax_lora_module_names(shapes)


TARGET_SETS = {
    "reference-defaults": (dict(target_modules=("q_proj", "k_proj", "v_proj", "out_proj", "fc1",
                                                "fc2")), {}),
    "detr-encoder-only": (dict(target_modules=("fc1", "fc2", "linear1", "linear2"),
                               apply_to_vision_encoder=False, apply_to_detr_encoder=True,
                               apply_to_detr_decoder=False, apply_to_geometry_encoder=False), {}),
    "processors": (dict(target_modules=("qkv", "fc1", "fc2", "linear1", "linear2")), {}),
    "processors-unscanned": (dict(target_modules=("qkv", "fc1", "fc2", "linear1", "linear2")),
                             dict(vit_scan_blocks=False)),
}


NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "torch_ref_lora_names.json")


def jax_names():
    """{case: JAX's ``lora_module_names``} over TARGET_SETS (JAX
    ``eval_shape`` of each tiny model, a few seconds)."""
    return {case: _jax_names(jax_tiny(**ckw), JLoRAConfig(rank=2, alpha=4.0, **lkw))
            for case, (lkw, ckw) in TARGET_SETS.items()}


def write_names(path: str = NAMES) -> str:
    with open(path, "w") as f:
        json.dump(jax_names(), f, indent=0, sort_keys=True)
    return path


def stored_names():
    with open(NAMES) as f:
        return json.load(f)


def test_stored_names_are_current():
    assert stored_names() == jax_names()


@pytest.mark.parametrize("case", list(TARGET_SETS))
def test_lora_module_names_match_jax(case):
    lkw, ckw = TARGET_SETS[case]
    want = stored_names()[case]
    model = build_sam3_image_model(tiny_model_config(**ckw), lora=LoRAConfig(rank=2, alpha=4.0,
                                                                                **lkw),
                                   device="meta")
    assert want and lora_module_names(model) == want


if __name__ == "__main__":
    print(write_names())
