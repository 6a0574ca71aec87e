"""The work a cell's units need, counted from the configuration's shapes,
and the H100's peaks that it is held against.

The reference model runs once on the ``meta`` device (shapes only, no data)
under ``torch.utils.flop_counter.FlopCounterMode``, with its attention
chunks not rematerialized: the operations of the forward, and for training
the backward autograd forms (the inputs' gradients through the frozen
layers, the adapters' weight gradients, the attention backward), with no
recomputation. The matcher's assignment, which needs values, is replaced by
a fixed one for the count; it does no products. The same run records the
calls that the program's kernels serve: the ViT's and the fusion encoder's
self-attention (``attention_work``, as ``sam3_lora_tpu_torch/measure.py``
counts it) and the frozen int8 products (``gemm_int8_work``).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM, dense, from NVIDIA's data sheet
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
MEM_RATE = 3.35e12


def attention_work(seqs: int, l: int, head_dim: int, backward: bool) -> Tuple[float, float]:
    """(operations, bytes) of one attention call over ``seqs`` (batch x head)
    sequences of L rows: 4 L^2 dh a sequence forward (QK^T and PV), 2.5x
    that backward; bf16 q, k, v (and o, do, the fp32 lse) read once, o (dq,
    dk, dv) written once."""
    elems = seqs * l * head_dim
    ops = 4.0 * l * l * head_dim * seqs
    if backward:
        return 2.5 * ops, 8 * elems * 2 + seqs * l * 4
    return ops, 4 * elems * 2


def gemm_int8_work(m: int, k: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of y (M, N) = x (M, K) . W (N, K)^T with int8 W:
    bf16 x read and quantized once, the int8 weight and its fp32 scales read
    once, bf16 y written once."""
    return 2.0 * m * k * n, m * k * 2 + n * k + n * 4 + m * n * 2


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The roofline bound: the larger of operations over the peak rate and
    bytes over the memory rate."""
    return max(ops / peak, nbytes / MEM_RATE)


def _meta_batch(cfg, rows: int, images: int, targets: bool):
    from .reference.geometry import GeoPrompt
    from .reference.sam3_image import Batch, Targets

    d, r, t, m = "meta", cfg.img_size, cfg.max_targets, cfg.mask_loss_resolution
    tg = None
    if targets:
        tg = Targets(boxes=torch.zeros(rows, t, 4, device=d),
                     valid=torch.zeros(rows, t, dtype=torch.bool, device=d),
                     masks=torch.zeros(rows, t, m, m, device=d),
                     mask_valid=torch.zeros(rows, t, dtype=torch.bool, device=d),
                     is_exhaustive=torch.ones(rows, dtype=torch.bool, device=d))
    return Batch(images=torch.zeros(images, 3, r, r, dtype=torch.uint8, device=d),
                 token_ids=torch.zeros(rows, cfg.text_context_length, dtype=torch.long, device=d),
                 img_ids=torch.zeros(rows, dtype=torch.long, device=d) if images == 1
                 else torch.arange(rows, device=d),
                 geo=GeoPrompt.empty(rows, cfg.max_prompt_boxes, device=d), targets=tg)


@functools.lru_cache(maxsize=16)
def _count(mcfg, lcfg, unit: str, rows: int) -> Dict:
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import model as ref_model
    from .reference import numerics, sam3_image
    from .reference.losses import LossConfig, compute_losses

    model = ref_model.build(mcfg, lcfg, "meta")
    cfg = model.spec.model
    record = []
    saved = (sam3_image.hungarian_match, sam3_image.one_to_many_match)

    def fixed_o2o(logits, boxes, tb, tv):
        return torch.zeros(tv.shape, dtype=torch.long, device=tv.device)

    def fixed_o2m(logits, boxes, tb, tv, topk):
        shape = (*tv.shape, topk)
        return (torch.zeros(shape, dtype=torch.long, device=tv.device),
                torch.zeros(shape, dtype=torch.bool, device=tv.device))

    sam3_image.hungarian_match, sam3_image.one_to_many_match = fixed_o2o, fixed_o2m
    numerics.NUM.remat, numerics.NUM.record = False, record
    try:
        with FlopCounterMode(display=False) as counter:
            if unit == "train":
                ref_model.trainable(model)
                out = model(_meta_batch(cfg, rows, rows, True))
                compute_losses(out, _meta_batch(cfg, rows, rows, True).targets,
                               LossConfig())["core_loss"].backward()
            elif unit == "request":
                with torch.no_grad():
                    model(_meta_batch(cfg, rows, 1, False))
            elif unit == "image":
                with torch.no_grad():
                    model.backbone_image(_meta_batch(cfg, 1, 1, False).images)
            elif unit == "prompt":
                with torch.no_grad():
                    feats, poss = model.backbone_image(_meta_batch(cfg, 1, 1, False).images)
                    base = counter.get_total_flops()
                    record.clear()
                    model.ground(feats, poss, _meta_batch(cfg, 1, 1, False))
            else:
                raise ValueError(f"unknown unit of work {unit!r}")
        flops = counter.get_total_flops() - (base if unit == "prompt" else 0)
    finally:
        sam3_image.hungarian_match, sam3_image.one_to_many_match = saved
        numerics.NUM.remat, numerics.NUM.record = True, None
    backward = unit == "train"
    attn = [0.0, 0.0, 0.0]
    gemm = [0.0, 0.0, 0.0]
    for rec in record:
        if rec[0] == "attn" and rec[1] in ("vit", "enc"):
            _, _, seqs, lq, _, dh = rec
            for bwd in ((False, True) if backward else (False,)):
                ops, nb = attention_work(seqs, lq, dh, bwd)
                attn[0] += ops
                attn[1] += nb
                attn[2] += least_seconds(ops, nb, PEAK_BF16)
        elif rec[0] == "int8":
            ops, nb = gemm_int8_work(*rec[1:])
            gemm[0] += ops
            gemm[1] += nb
            gemm[2] += least_seconds(ops, nb, PEAK_INT8)
    return {"flops": float(flops), "attn": tuple(attn), "int8": tuple(gemm)}


def unit_work(config: Dict, unit: str, rows: int = 1) -> Dict:
    """{flops, attn: (ops, bytes, least s), int8: (ops, bytes, least s)} of
    one unit of work: a training update of ``rows`` images ("train"), a
    request of ``rows`` prompts on one image ("request"), a backbone pass
    ("image") or one prompt against a cached image ("prompt")."""
    from .configs_io import ref_configs

    return _count(*ref_configs(config), unit, rows)
