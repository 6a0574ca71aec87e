"""The port's pre- and postprocess against the JAX engine's PIL resizes.

``preprocess``: the port resizes uint8 with ``F.interpolate(antialias=True)``
and the JAX engine with PIL ``BILINEAR``. Both round to uint8 before /255, and
they differ by at most one grey level (2/255 after the 0.5/0.5 normalization),
on at most 5% of the values (measured: 0-3.7%). The mask resize runs in one
float pass, PIL in two uint8-rounded passes: they may disagree only where the
interpolated value lies within one grey level of the 127.5 threshold, on at
most 1% of the pixels (measured: 0-0.8%).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from sam3_lora_tpu.inference import SAM3LoRAInference as JaxInference
from sam3_lora_tpu_torch.config import ModelConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference, resize_masks_to


@pytest.mark.parametrize("cfg, hw", [
    (tiny_model_config(), (90, 120)),
    (tiny_model_config(), (40, 60)),
    (tiny_model_config(), (30, 20)),
    (ModelConfig(), (900, 1200)),
], ids=["tiny-90x120", "tiny-40x60", "tiny-30x20", "full-900x1200"])
def test_preprocess_matches_jax_pil(cfg, hw):
    image = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3)).astype(np.uint8)
    engine = SimpleNamespace(cfg=cfg)
    out, out_hw = SAM3LoRAInference.preprocess(engine, image)
    ref, ref_hw = JaxInference.preprocess(engine, image)
    assert out_hw == ref_hw == hw
    assert out.shape == ref.shape == (1, 3, cfg.img_size, cfg.img_size)
    assert out.dtype == ref.dtype == np.float32
    diff = np.abs(out - ref)
    assert diff.max() <= 2.0 / 255.0 + 1e-6
    assert (diff > 0).mean() <= 0.05


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
    ((16, 16), (12, 10)),   # downsampling: the antialiased filter
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
    assert bad.mean() <= 0.01
    value = F.interpolate(torch.from_numpy(masks)[:, None].float(), size=dst, mode="bilinear",
                          align_corners=False, antialias=True)[:, 0].numpy() * 255.0
    assert (np.abs(value[bad] - 127.5) <= 1.0).all()
