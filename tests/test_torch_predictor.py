"""The port's interactive image predictor (``sam3_lora_tpu_torch/predictor.py``)
against the JAX package's, on the tiny config with the same seeded weights:
the processor's (as ``test_torch_processor.py`` draws them) and the
``TrackerCore``'s (a JAX predictor-init tree filled from numpy, loaded
through the weight bridge), the same uint8 images, fp32 on both sides.

``predict``: one positive point with multimask output; a box plus a
negative point, single output (the dynamic selection); the same with
``return_logits``; points in model pixels (``normalize_coords=False``);
and ``predict_batch`` over two images. Tolerance 2e-4 absolute and relative
on the IoU predictions, the low-resolution logits and the upscaled logits,
as the processor's; the boolean masks equal wherever the logit is not
within 2e-4 of the threshold.

The JAX results are stored in ``tests/data/torch_ref_predictor.npz``;
``test_reference_is_current`` (slow: it jits the JAX processor and heads)
recomputes them. Rewrite: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_predictor.py``.

Also: the upscale (``ops/interpolate.py::resize_bilinear`` with antialias)
against ``jax.image.resize(..., "bilinear")``, borders included, for 288 ->
1200x900 and smaller cases; ``predict`` runs no backbone; prompts pad to
``MAX_POINTS`` with a box's corners first."""

import collections
import os

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch import config as tc
from sam3_lora_tpu_torch.ops.interpolate import resize_bilinear
from sam3_lora_tpu_torch.predictor import MAX_POINTS, SAM3InteractiveImagePredictor
from sam3_lora_tpu_torch.processor import Sam3Processor
from sam3_lora_tpu_torch.utils.checkpoint import load_jax_params

from torch_port_helpers import fill_params, load_reference, nested, save_reference

TOL = 2e-4
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_ref_predictor.npz")
TARGETS = ("qkv", "fc1", "fc2", "linear1", "linear2")
IMAGE = np.random.RandomState(5).randint(0, 256, (40, 60, 3)).astype(np.uint8)
IMAGE2 = np.ascontiguousarray(IMAGE[::-1])
CALLS = (  # predict kwargs
    dict(point_coords=[[20.0, 10.0]], point_labels=[1], multimask_output=True),
    dict(point_coords=[[30.0, 25.0]], point_labels=[0], box=[5.0, 5.0, 50.0, 35.0],
         multimask_output=False),
    dict(point_coords=[[30.0, 25.0]], point_labels=[0], box=[5.0, 5.0, 50.0, 35.0],
         multimask_output=False, return_logits=True),
    dict(point_coords=[[12.0, 40.0], [3.0, 50.0]], point_labels=[1, 1], multimask_output=True,
         return_logits=True, normalize_coords=False),
)
BATCH = ([[[10.0, 30.0]], [[25.0, 12.0]]], [[1], [1]])  # predict_batch points, labels per image
OUT = ("masks", "iou", "low_res")


def jax_reference():
    """-> (processor specs, tracker specs, {name: array}): the JAX
    predictor's results of CALLS on IMAGE, then predict_batch."""
    import jax.numpy as jnp
    from flax import traverse_util

    from sam3_lora_tpu import predictor as jpredictor
    from sam3_lora_tpu import processor as jax_processor
    from sam3_lora_tpu.config import LoRAConfig, tiny_model_config
    from sam3_lora_tpu.models import build_sam3_image_model as build_jax
    from sam3_lora_tpu.models.geometry import GeoPrompt as JGeoPrompt
    from sam3_lora_tpu.models.layers import Spec as JSpec
    from sam3_lora_tpu.models.sam3_image import Batch as JBatch
    from sam3_lora_tpu.models.tracker import TrackerCore
    from torch_port_helpers import param_specs

    cfg = tiny_model_config()
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS)
    r = cfg.img_size
    jb = JBatch(images=jnp.zeros((1, 3, r, r)), token_ids=jnp.zeros((1, cfg.text_context_length),
                                                                     jnp.int32),
                img_ids=jnp.zeros((1,), jnp.int32), geo=JGeoPrompt.empty(1, cfg.max_prompt_boxes))
    specs = param_specs(build_jax(cfg, lora=lora), jb, train=False)
    flat = fill_params(specs)
    params = traverse_util.unflatten_dict({p: jnp.asarray(flat[".".join(p)]) for p, _ in specs})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_processor, "init_model", lambda model, key: params)
        proc = jax_processor.Sam3Processor(cfg, lora)

    fh = cfg.img_size // cfg.patch_size
    d = cfg.d_model
    core = TrackerCore(JSpec(model=cfg, lora=None), d_model=d, mem_dim=max(d // 4, 8),
                       feat_sizes=(fh, fh))

    def init(m):  # the JAX predictor's own init path
        cond = m.no_memory_features(jnp.zeros((1, d, fh, fh)))
        hi = [jnp.zeros((1, d, 4 * fh, 4 * fh)), jnp.zeros((1, d, 2 * fh, 2 * fh))]
        return m.predict_masks(cond, hi, point_coords=jnp.zeros((1, MAX_POINTS, 2)),
                               point_labels=jnp.full((1, MAX_POINTS), -1, jnp.int32),
                               multimask_output=True)

    tspecs = param_specs(core, method=init)
    tflat = fill_params(tspecs, seed=1)
    tparams = traverse_util.unflatten_dict({p: jnp.asarray(tflat[".".join(p)])
                                            for p, _ in tspecs})
    pred = jpredictor.SAM3InteractiveImagePredictor(proc, tracker_params=tparams)
    pred.set_image(IMAGE)
    res = {}
    for i, kw in enumerate(CALLS):
        for k, v in zip(OUT, pred.predict(**kw)):
            res[f"{i}/{k}"] = np.asarray(v)
    for i, out in enumerate(pred.predict_batch([IMAGE, IMAGE2], *BATCH)):
        for k, v in zip(OUT, out):
            res[f"batch{i}/{k}"] = np.asarray(v)
    # the logits of the batch's boolean masks, for the threshold margin
    for i, img in enumerate((IMAGE, IMAGE2)):
        pred.set_image(img)
        res[f"batch{i}/logits"] = np.asarray(pred.predict(BATCH[0][i], BATCH[1][i],
                                                          return_logits=True)[0])
    return specs, tspecs, res


def port_predictor(specs, tspecs):
    proc = Sam3Processor(tc.tiny_model_config(),
                         tc.LoRAConfig(rank=4, alpha=8.0, target_modules=TARGETS), device="cpu")
    load_jax_params(proc.model, fill_params(specs))
    return SAM3InteractiveImagePredictor(proc, tracker_params=nested(fill_params(tspecs, seed=1)))


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def check_against(pred, want):
    pred.set_image(IMAGE)
    assert pred._orig_size == (40, 60)
    for i, kw in enumerate(CALLS):
        masks, iou, low = pred.predict(**kw)
        n = 3 if kw["multimask_output"] else 1
        assert masks.shape == (n, 40, 60) and iou.shape == (n,) and low.shape[0] == n
        _close(iou, want[f"{i}/iou"], f"{i}/iou")
        _close(low, want[f"{i}/low_res"], f"{i}/low_res")
        if kw.get("return_logits"):
            assert masks.dtype == np.float32
            _close(masks, want[f"{i}/masks"], f"{i}/masks")
        else:
            assert masks.dtype == bool
            lg = pred.predict(**dict(kw, return_logits=True))[0]
            sure = np.abs(lg) > TOL
            np.testing.assert_array_equal(masks[sure], want[f"{i}/masks"][sure])
    # CALLS[2] is CALLS[1] with logits: its threshold gives CALLS[1]'s masks
    np.testing.assert_array_equal(want["2/masks"] > 0, want["1/masks"])
    for i, out in enumerate(pred.predict_batch([IMAGE, IMAGE2], *BATCH)):
        masks, iou, low = out
        _close(iou, want[f"batch{i}/iou"], f"batch{i}/iou")
        _close(low, want[f"batch{i}/low_res"], f"batch{i}/low_res")
        sure = np.abs(want[f"batch{i}/logits"]) > TOL
        np.testing.assert_array_equal(masks[sure], want[f"batch{i}/masks"][sure])


def _load():
    specs, arrays = load_reference(REF)
    n = int(arrays.pop("n_processor_params"))
    return specs[:n], specs[n:], arrays


@pytest.fixture(scope="module")
def pair():
    specs, tspecs, want = _load()
    return want, port_predictor(specs, tspecs)


def test_predictor_matches_jax(pair):
    want, pred = pair
    check_against(pred, want)


def test_predict_runs_no_backbone(pair, monkeypatch):
    _, pred = pair
    pred.set_image(IMAGE)
    calls = collections.Counter()
    orig = pred.proc.model.backbone_image

    def spy(*a, **k):
        calls["backbone_image"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(pred.proc.model, "backbone_image", spy)
    for kw in CALLS:
        pred.predict(**kw)
    assert calls["backbone_image"] == 0
    pred.predict_batch([IMAGE, IMAGE2], *BATCH)
    assert calls["backbone_image"] == 2  # one set_image an image


def test_prompt_padding(pair):
    _, pred = pair
    pred.set_image(IMAGE)
    coords, labels = pred._prep_prompts(np.arange(20, dtype=np.float32).reshape(10, 2),
                                        np.ones(10), box=[1, 2, 3, 4], normalize_coords=False)
    assert coords.shape == (1, MAX_POINTS, 2) and labels.tolist() == [[2, 3] + [1] * 6]
    np.testing.assert_array_equal(coords[0, :2].numpy(), [[1, 2], [3, 4]])
    coords, labels = pred._prep_prompts(None, None, None)
    assert labels.tolist() == [[-1] * MAX_POINTS]
    with pytest.raises(RuntimeError, match="set_image"):
        pred.reset_predictor() or pred.predict(point_coords=[[1, 1]], point_labels=[1])


def test_chip_smoke_heads_check_on_the_cpu(pair):
    """chip_smoke's heads check (the device's heads against an fp32 CPU copy
    on the cached features), rehearsed with the CPU on both sides: equal."""
    import chip_smoke

    _, pred = pair
    pred.set_image(IMAGE)
    prompts = (CALLS[0], dict(CALLS[1], box=[5.0, 5.0, 50.0, 35.0]))
    assert chip_smoke.heads_against_cpu(pred, prompts) <= 1e-6


@pytest.mark.parametrize("src,dst", [((288, 288), (1200, 900)), ((16, 16), (40, 60)),
                                     ((16, 16), (16, 37)), ((64, 48), (20, 30))])
def test_upscale_matches_jax_image_resize(src, dst):
    """Half-pixel bilinear with the edge taps renormalized: an upscale, a
    non-square one and (antialiased) a downscale, borders included. 2e-4
    absolute: the sample position (o + 0.5) * in / out - 0.5 is rounded in
    fp32 in another order, off by ~3e-5 pixel at 1200 outputs, which moves a
    value of unit scale by up to ~1e-4."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(2).standard_normal((3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst, antialias=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=TOL)


def test_reference_is_current():
    specs, tspecs, live = jax_reference()
    s_specs, s_tspecs, want = _load()
    same = lambda a, b: [(".".join(p), tuple(s)) for p, s in a] == \
        [(".".join(p), tuple(s)) for p, s in b]  # noqa: E731
    assert same(specs, s_specs) and same(tspecs, s_tspecs)
    for k in want:
        np.testing.assert_array_equal(live[k], want[k], err_msg=k)
    check_against(port_predictor(specs, tspecs), live)


if __name__ == "__main__":
    specs, tspecs, res = jax_reference()
    res["n_processor_params"] = np.asarray(len(specs))
    print(save_reference(REF, list(specs) + list(tspecs), res))
