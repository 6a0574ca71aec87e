"""The work counts against hand counts at the tiny configuration."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as ref_model
from benchmark.reference.config import LoRAConfig, tiny_model_config


def config(**model):
    cfg = dataclasses.asdict(tiny_model_config(**model))
    return {"model": {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()},
            "lora": dataclasses.asdict(LoRAConfig(rank=4, target_modules=("qkv", "fc1")))}


def test_attention_and_gemm_formulas():
    assert work.attention_work(3, 10, 8, False) == (4 * 100 * 8 * 3, 4 * 3 * 10 * 8 * 2)
    assert work.attention_work(3, 10, 8, True) == (2.5 * 4 * 100 * 8 * 3,
                                                   8 * 3 * 10 * 8 * 2 + 3 * 10 * 4)
    assert work.gemm_int8_work(5, 7, 11) == (2 * 5 * 7 * 11, 5 * 7 * 2 + 11 * 7 + 11 * 4 + 5 * 11 * 2)
    assert work.least_seconds(989e12, 1.0, work.PEAK_BF16) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12, work.PEAK_BF16) == pytest.approx(1.0)


def test_backbone_pass_by_hand():
    """One image at the tiny config: 56/14 = 4x4 tokens of width 32, 4 blocks
    (1 and 3 global over 16 tokens, 0 and 2 over four 2x2 windows), 2 heads
    of 16, MLP 128; every ViT product is int8 (min dim 16)."""
    w = work.unit_work(config(base_quant="int8", base_quant_min_dim=16), "image")
    per_block = 2 * 16 * (32 * 96 + 32 * 32 + 32 * 128 + 128 * 32)
    assert w["int8"][0] == 4 * per_block
    bytes_ = sum(m * k * 2 + n * k + n * 4 + m * n * 2
                 for m, k, n in [(16, 32, 96), (16, 32, 32), (16, 32, 128), (16, 128, 32)]) * 4
    assert w["int8"][1] == bytes_
    windowed = 4 * 4 * 4 * 16 * (4 * 2)    # 4 windows x 2 heads of L = 4
    global_ = 4 * 16 * 16 * 16 * 2         # 2 heads of L = 16
    assert w["attn"][0] == 2 * windowed + 2 * global_


def test_vit_flops_by_hand():
    cfg = tiny_model_config()
    m = ref_model.build(cfg, LoRAConfig(rank=0), "meta")
    with FlopCounterMode(display=False) as c, torch.no_grad():
        m.backbone.vision_backbone.trunk(torch.zeros(1, 3, 56, 56, device="meta"))
    linear = 4 * 2 * 16 * (32 * 96 + 32 * 32 + 32 * 128 + 128 * 32)
    attn = 2 * (2 * 2 * 4 * 4 * 16 * 8) + 2 * (2 * 2 * 16 * 16 * 16 * 2)  # QK^T and PV
    patch = 2 * 16 * (3 * 14 * 14) * 32
    assert c.get_total_flops() == linear + attn + patch


def test_training_counts_the_backward():
    cfg = config()
    fwd = work.unit_work(cfg, "request", 2)["flops"]
    train = work.unit_work(cfg, "train", 2)["flops"]
    assert 1.5 * fwd < train < 4 * fwd
