"""The port's pre- and postprocess against the JAX engine's PIL resizes.

``preprocess`` and the mask resize run PIL's fixed-point bilinear resample
(``ops/interpolate.py::resize_pil_bilinear``) on the engine's device: both
equal the JAX engine's, which runs PIL on the host, value for value. The
tap table is held against a per-pixel evaluation of Pillow's
``precompute_coeffs`` and ``normalize_coeffs_8bpc``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from sam3_lora_tpu.inference import SAM3LoRAInference as JaxInference
from sam3_lora_tpu_torch.config import ModelConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference, resize_masks_to
from sam3_lora_tpu_torch.ops.interpolate import pil_bilinear_taps, resize_pil_bilinear


@pytest.mark.parametrize("cfg, hw", [
    (tiny_model_config(), (90, 120)),
    (tiny_model_config(), (40, 60)),
    (tiny_model_config(), (30, 20)),
    (tiny_model_config(), (48, 64)),
    (ModelConfig(), (900, 1200)),
    (ModelConfig(), (480, 640)),
], ids=["tiny-90x120", "tiny-40x60", "tiny-30x20", "tiny-48x64", "full-900x1200",
        "full-480x640"])
def test_preprocess_matches_jax_pil(cfg, hw):
    image = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3)).astype(np.uint8)
    engine = SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    out, out_hw = SAM3LoRAInference.preprocess(engine, image)
    ref, ref_hw = JaxInference.preprocess(engine, image)
    assert out_hw == ref_hw == hw
    assert out.shape == ref.shape == (1, 3, cfg.img_size, cfg.img_size)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def _pil_resize_masks(masks: np.ndarray, hw) -> np.ndarray:
    """The JAX engine's mask resize (sam3_lora_tpu/inference.py, predict)."""
    h, w = hw
    return np.stack([
        np.asarray(Image.fromarray((m * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
                   np.float32) > 127.5
        for m in masks
    ])


@pytest.mark.parametrize("src, dst", [
    ((16, 16), (90, 120)),  # upsampling, as from the tiny model's masks
    ((16, 16), (12, 10)),   # downsampling: the widened filter
    ((16, 16), (16, 16)),
    ((288, 288), (333, 777)),
], ids=["up", "down", "same", "full-width"])
def test_mask_resize_matches_pil(src, dst):
    rng = np.random.RandomState(0)
    masks = rng.rand(4, *src) > 0.5
    out = resize_masks_to(torch.from_numpy(masks), dst).numpy()
    ref = _pil_resize_masks(masks, dst)
    assert out.shape == ref.shape == (4, *dst)
    bad = out != ref
    assert bad.sum() == 0


def _taps_by_pixel(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` (bilinear) and ``normalize_coeffs_8bpc``,
    one output pixel and one tap at a time: {pixel: [(input index, fixed-
    point weight), ...]} over the pixel's window."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = fs
    out = {}
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        ws = [max(0.0, 1.0 - abs((x - center + 0.5) * (1.0 / fs))) for x in range(xmin, xmax)]
        total = 0.0
        for w in ws:
            total += w
        ks = [w / total for w in ws]
        out[xx] = [(xmin + i, int(-0.5 + k * 2**22) if k < 0 else int(0.5 + k * 2**22))
                   for i, k in enumerate(ks)]
    return out


@pytest.mark.parametrize("in_size, out_size", [
    (16, 90), (64, 56), (120, 56), (1200, 1008), (1920, 1008), (33, 33), (7, 1), (1, 9),
], ids=["up", "down", "down-2x", "full-900x1200", "full-1080x1920", "same", "to-one", "from-one"])
def test_tap_table_matches_pillow_formula(in_size, out_size):
    index, weight = pil_bilinear_taps(in_size, out_size)
    want = _taps_by_pixel(in_size, out_size)
    ksize = int(math.ceil(max(in_size / out_size, 1.0))) * 2 + 1
    assert index.shape == weight.shape == (out_size, ksize)
    assert weight.dtype == np.int32 and (index >= 0).all() and (index < in_size).all()
    for xx, taps in want.items():
        n = len(taps)
        assert [(int(i), int(w)) for i, w in zip(index[xx, :n], weight[xx, :n])] == taps
        assert (weight[xx, n:] == 0).all()


@pytest.mark.parametrize("hw, size", [((37, 53), (56, 56)), ((56, 56), (56, 56)),
                                      ((70, 20), (31, 90))], ids=["up", "same", "mixed"])
def test_resize_pil_bilinear_on_channels_and_batches(hw, size):
    """HWC images and (N, H, W) stacks, PIL's pixels; non-uint8 is refused."""
    rng = np.random.RandomState(hw[0])
    image = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(image).resize(size[::-1], Image.BILINEAR))
    got = resize_pil_bilinear(torch.from_numpy(image), size, dims=(0, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    stack = torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1)))
    np.testing.assert_array_equal(resize_pil_bilinear(stack, size).numpy(),
                                  want.transpose(2, 0, 1))
    with pytest.raises(TypeError, match="uint8"):
        resize_pil_bilinear(stack.float(), size)
