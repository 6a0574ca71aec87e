"""Each model module of the PyTorch port against its JAX counterpart on
``tiny_model_config()``: same numpy-seeded weights through the weight bridge,
same numpy inputs, fp32. Tolerance 1e-4 (absolute and relative): a few
stacked fp32 layers whose sums run in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
from sam3_lora_tpu.models import decoder as jdec
from sam3_lora_tpu.models import fusion_encoder as jfus
from sam3_lora_tpu.models import geometry as jgeo
from sam3_lora_tpu.models import neck as jneck
from sam3_lora_tpu.models import scoring as jscore
from sam3_lora_tpu.models import seg_head as jseg
from sam3_lora_tpu.models import text_encoder as jtext
from sam3_lora_tpu.models import vit as jvit
from sam3_lora_tpu.models.layers import Spec as JSpec
from sam3_lora_tpu_torch.models import decoder, fusion_encoder, geometry, neck, scoring
from sam3_lora_tpu_torch.models import seg_head, text_encoder, vit
from sam3_lora_tpu_torch.models.layers import Spec
from sam3_lora_tpu_torch.models.lora import apply_lora
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import assert_close, jax_apply, random_jax_params

TOL = 1e-4
LORA = LoRAConfig(rank=4, alpha=8.0,
                  target_modules=("qkv", "fc1", "fc2", "c_fc", "linear1", "linear2"),
                  apply_to_geometry_encoder=True, apply_to_mask_decoder=True)
CFG = tiny_model_config()
D = CFG.d_model
FEAT = CFG.feat_size


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _pair(jax_cls, port_cls, *args, cfg=CFG, **kwargs):
    """Build the JAX module and its port with the same random weights; the
    LoRA config targets the same layers in both (by their basenames)."""
    jm = jax_cls(JSpec(model=cfg, lora=LORA))
    params, flat = random_jax_params(jm, *args, **kwargs)
    pm = port_cls(Spec(model=cfg, lora=LORA))
    apply_lora(pm, LORA)
    load_jax_params(pm, flat)
    return jm, params, pm.eval()  # the JAX side runs train=False


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("scanned", [True, False])
def test_vit(scanned):
    cfg = CFG.replace(vit_scan_blocks=scanned)
    x = _randn(2, 3, cfg.img_size, cfg.img_size)
    jm, params, pm = _pair(jvit.ViT, vit.ViT, _j(x), cfg=cfg)
    assert any(n.endswith("qkv") for n, m in pm.named_modules() if getattr(m, "lora_a", None) is not None)
    assert_close(pm(_t(x)), jax_apply(jm, params, _j(x)), rtol=TOL, atol=TOL)


def test_vit_uint8_input():
    u8 = np.random.RandomState(1).randint(0, 256, (1, 3, CFG.img_size, CFG.img_size)).astype(np.uint8)
    jm, params, pm = _pair(jvit.ViT, vit.ViT, _j(u8))
    assert_close(pm(_t(u8)), jax_apply(jm, params, _j(u8)), rtol=TOL, atol=TOL)


def test_neck():
    x = _randn(2, CFG.vit_dim, FEAT, FEAT)
    jm, params, pm = _pair(jneck.FPNNeck, neck.FPNNeck, _j(x))
    feats, poss = pm(_t(x))
    jfeats, jposs = jax_apply(jm, params, _j(x))
    assert len(feats) == len(jfeats) == 4
    for a, b in zip(feats + poss, list(jfeats) + list(jposs)):
        assert_close(a, b, rtol=TOL, atol=TOL)


def test_text_encoder():
    ids = np.array([[49406, 320, 1929, 49407, 0, 0, 0, 0], [49406, 7622, 49407, 0, 0, 0, 0, 0]],
                   np.int32)
    jm, params, pm = _pair(jtext.VETextEncoder, text_encoder.VETextEncoder, _j(ids))
    mask, tok = pm(_t(ids).long())
    jmask, jtok = jax_apply(jm, params, _j(ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert_close(tok, jtok, rtol=TOL, atol=TOL)


def _geo_inputs():
    boxes = np.array([[[0.5, 0.5, 0.4, 0.3], [0.0, 0.0, 0.0, 0.0]],
                      [[0.3, 0.6, 0.5, 0.7], [0.7, 0.2, 0.2, 0.1]]], np.float32)
    mask = np.array([[False, True], [False, False]])
    labels = np.array([[1, 1], [1, 0]], np.int32)
    feats = _randn(2, FEAT * FEAT, D, seed=2)
    pos = _randn(2, FEAT * FEAT, D, seed=3)
    return boxes, mask, labels, feats, pos


@pytest.mark.parametrize("with_points", [False, True])
def test_geometry_encoder(with_points):
    boxes, mask, labels, feats, pos = _geo_inputs()
    pts = np.array([[[0.2, 0.3]], [[0.8, 0.5]]], np.float32) if with_points else None
    pmask = np.array([[False], [True]]) if with_points else None
    plabels = np.ones((2, 1), np.int32) if with_points else None
    jprompt = jgeo.GeoPrompt(
        _j(boxes), _j(mask), _j(labels),
        *(None if a is None else _j(a) for a in (pts, pmask, plabels)),
    )
    jm, params, pm = _pair(jgeo.GeometryEncoder, geometry.GeometryEncoder,
                           jprompt, _j(feats), _j(pos), (FEAT, FEAT))
    tprompt = geometry.GeoPrompt(
        _t(boxes), _t(mask), _t(labels).long(),
        *(None if a is None else _t(a) for a in (pts, pmask, plabels)),
    )
    seq, smask = pm(tprompt, _t(feats), _t(pos), (FEAT, FEAT))
    jseq, jsmask = jax_apply(jm, params, jprompt, _j(feats), _j(pos), (FEAT, FEAT))
    np.testing.assert_array_equal(smask.numpy(), np.asarray(jsmask))
    assert_close(seq, jseq, rtol=TOL, atol=TOL)


def test_fusion_encoder():
    src, pos = _randn(2, FEAT * FEAT, D, seed=4), _randn(2, FEAT * FEAT, D, seed=5)
    prompt = _randn(2, 6, D, seed=6)
    pmask = np.array([[False] * 4 + [True] * 2, [False] * 6])
    jm, params, pm = _pair(jfus.TransformerEncoderFusion, fusion_encoder.TransformerEncoderFusion,
                           _j(src), _j(pos), _j(prompt), _j(pmask))
    out = pm(_t(src), _t(pos), _t(prompt), _t(pmask))
    assert_close(out, jax_apply(jm, params, _j(src), _j(pos), _j(prompt), _j(pmask)),
                 rtol=TOL, atol=TOL)


def test_decoder():
    mem, pos = _randn(2, FEAT * FEAT, D, seed=7), _randn(2, FEAT * FEAT, D, seed=8)
    text = _randn(2, 6, D, seed=9)
    tmask = np.array([[False] * 3 + [True] * 3, [False] * 6])
    args = (_j(mem), _j(pos), _j(text), _j(tmask), (FEAT, FEAT))
    jm, params, pm = _pair(jdec.TransformerDecoder, decoder.TransformerDecoder, *args)
    out = pm(_t(mem), _t(pos), _t(text), _t(tmask), (FEAT, FEAT))
    ref = jax_apply(jm, params, *args)
    for name in jdec.DecoderOutput._fields:
        assert_close(getattr(out, name), getattr(ref, name), rtol=TOL, atol=TOL, name=name)


def test_scoring():
    hs = _randn(2, 2, CFG.num_queries, D, seed=10)
    prompt = _randn(2, 6, D, seed=11)
    pmask = np.array([[False] * 2 + [True] * 4, [False] * 6])
    jm, params, pm = _pair(jscore.DotProductScoring, scoring.DotProductScoring,
                           _j(hs), _j(prompt), _j(pmask))
    assert_close(pm(_t(hs), _t(prompt), _t(pmask)),
                 jax_apply(jm, params, _j(hs), _j(prompt), _j(pmask)), rtol=TOL, atol=TOL)


def test_seg_head():
    feats = [_randn(2, D, FEAT * s, FEAT * s, seed=12 + s) for s in (4, 2, 1)]
    enc = _randn(2, FEAT * FEAT, D, seed=20)
    queries = _randn(2, CFG.num_queries, D, seed=21)
    prompt = _randn(2, 6, D, seed=22)
    pmask = np.array([[False] * 5 + [True], [False] * 6])
    jargs = ([_j(f) for f in feats], _j(enc), _j(queries), _j(prompt), _j(pmask), (FEAT, FEAT))
    jm, params, pm = _pair(jseg.UniversalSegmentationHead, seg_head.UniversalSegmentationHead,
                           *jargs)
    out = pm([_t(f) for f in feats], _t(enc), _t(queries), _t(prompt), _t(pmask), (FEAT, FEAT))
    ref = jax_apply(jm, params, *jargs)
    for k in ("pred_masks", "semantic_seg"):
        assert_close(out[k], ref[k], rtol=TOL, atol=TOL, name=k)
