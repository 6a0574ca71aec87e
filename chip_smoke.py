"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device      - the card's name and power limit; TF32 off for fp32 math.
  2. build       - compile csrc/attention_fwd.cu, csrc/attention_bwd.cu and
                   csrc/gemm_int8.cu with nvcc (one process per source, in
                   parallel).
  3. kernels     - each attention entry point's forward kernel against its
                   plain PyTorch version, on the operands the serving path
                   hands it; the backward kernels (and the forward's
                   log-sum-exp) against attention_packed_bwd_plain on the
                   operands of the training path at batch 4; the int8 tier's
                   K4/K5/K6 against their plain versions at every ViT shape at
                   M = 5184 (serving) and 20736 (training), the text shapes at
                   M = 96 and a ragged M; bf16; errors, median CUDA-event
                   times, roofline bounds and a library yardstick each.
  4. slice       - SAM3LoRAInference at the full 848M config (bf16, seeded random
                   weights, nonzero adapters) answers three requests of 1, 2 and
                   3 prompts; every output finite and of the right shape; the
                   launch counters show the requests ran through the kernels.
  5. slice-int8  - the same with base_quant="int8" and GEMM_LORA_FUSED on: the
                   adapted qkv/fc1/fc2 take K5, proj and the text GEMMs K4.
  6. train       - Trainer.fit at the full config, batch 4, LoRA on qkv, fc1,
                   fc2, linear1 and linear2, over seeded random images and
                   targets batched by the port's collate: one warm-up and three
                   timed steps with finite losses; step times, peak memory, and
                   forward and backward launch counts equal to the design's.
  7. train-int8  - the same with base_quant="int8" and GEMM_BWD_KERNEL on: K4
                   forward (remat replays included) and K6 for the fc1/fc2 dx.
  8. small       - a small config whose path runs every attention kernel: its
                   eval forward and one training step (loss, matching and
                   adapter gradients) in bf16 on the card against the same in
                   fp32 on the CPU; then again with its ViT in the int8 tier.
Then one JSON line of the kernels, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sam3_lora_tpu_torch.config import LoRAConfig, ModelConfig, TrainConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models import Batch, build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import trainable_parameters
from sam3_lora_tpu_torch.ops import _cuda, attention_kernel, gemm_int8, quant
from sam3_lora_tpu_torch.ops.long_attention import (
    long_attention_packed,
    long_attention_packed_plain,
    long_attention_rope_packed,
    long_attention_rope_packed_plain,
)
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import (
    window_attention_rope_packed,
    window_attention_rope_packed_plain,
)
from sam3_lora_tpu_torch.train.data import DataLoader, Sample
from sam3_lora_tpu_torch.train.losses import compute_losses
from sam3_lora_tpu_torch.train.prefetch import batch_to_device
from sam3_lora_tpu_torch.train.trainer import Trainer

SEED = 0
# max |kernel - plain| <= KERNEL_RTOL * max |plain|. Both round an fp32 result
# to bf16 and may land one ulp apart, at most 2**-7 of max |plain|; the
# kernel's bf16 P adds less. About 2.5 ulps at the largest output. On an
# H100 (700 W) the forward errors were 0.22x (K1), 0.24x (K2) and 0.19x (K3)
# of the bound; a copy of the kernel that skipped its second K/V tile erred
# by 27x, 13x and 14x of it.
KERNEL_RTOL = 2e-2
# The backward's gradients: max |kernel - plain| <= KERNEL_BWD_RTOL * max
# |plain| per gradient; the kernel also rounds P and dS to bf16 before their
# products. Measured on an H100 (700 W) at 0.16x-0.38x of 2e-2 (at most one
# bf16 ulp of the largest gradient); a copy of the kernel that skipped the
# second query tile of its dK/dV pass erred by 15x-43x of 2e-2 on dK and dV.
KERNEL_BWD_RTOL = 1.5e-2
LSE_ATOL = 2e-3    # natural-log units; measured 6.4e-4 (K1, bf16-rounded rotated q, k)
SMALL_TOL = 5e-2   # bf16 on the card against fp32 on the CPU, through the whole small model
# one training step of the small model, bf16 on the card against fp32 on the
# CPU: |loss - ref| <= LOSS_RTOL * |ref|, and for each adapter
# ||grad - ref|| <= GRAD_RTOL * ||ref|| (bf16 through ~20 layers and back;
# measured on an H100: loss 4.4e-4, gradients 3.3e-2 median, 5.5e-2 worst)
LOSS_RTOL = 5e-3
GRAD_RTOL = 1e-1
# the same with the small config's ViT in the int8 tier: the card quantizes
# bf16-rounded activations, the CPU fp32 ones, so some int8 values sit a step
# apart (1/127 of their row's largest entry) in each of the 16 quantized
# GEMMs, forward and back; that doubles the gradients' bound (measured on an
# H100 (700 W): 5.7e-2 median, 1.12e-1 worst, where the bf16 config gave 5.5e-2)
GRAD_RTOL_INT8 = 2e-1
# K5 and K6 against their plain versions: max |kernel - plain| <= GEMM_RTOL *
# max |plain|, one bf16 ulp of the largest output (the plain versions sum the
# bf16 products in another order); K4 must equal its plain version bit for bit
GEMM_RTOL = 8e-3
FWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_bwd.cu"
GEMM_SOURCE = "sam3_lora_tpu_torch/csrc/gemm_int8.cu"
# NVIDIA H100 SXM dense peaks and memory rate (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
MEM_RATE = 3.35e12
PROMPTS = (["crack"], ["crack", "wall"], ["crack", "wall", "stain"])
TRAIN_BATCH = 4
TRAIN_STEPS = 4  # one warm-up, three timed
LORA = LoRAConfig(target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
ENTRIES = (window_attention_rope_packed, long_attention_rope_packed, long_attention_packed)


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rope_tables(head_dim: int, side: int, scale_pos: float):
    ang = compute_axial_freqs(head_dim, side, side, scale_pos=scale_pos)
    return (torch.tensor(np.cos(ang), device="cuda"), torch.tensor(np.sin(ang), device="cuda"))


def main_path_operands(g: torch.Generator, n_images: int, n_prompts: int):
    """(entry, plain, args, replaces) of the three entry points, with the
    operands the main path hands them: q/k/v of the ViT are strided views of
    the (N, L, 3*1024) qkv projection, 16 heads x 64; the fusion encoder's
    are (B_prompts, 5184, 256), 8 heads x 32."""

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    cfg = ModelConfig()
    d, dh, feat, ws = cfg.vit_dim, cfg.vit_dim // cfg.vit_heads, cfg.feat_size, cfg.vit_window_size
    n_win = (feat // ws) ** 2 * n_images
    cases = []
    qkv = randn(n_win, ws * ws, 3 * d)
    cos, sin = rope_tables(dh, ws, 1.0)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, cos, sin)
    cases.append((window_attention_rope_packed, window_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/window_attention.py:663"))
    qkv = randn(n_images, feat * feat, 3 * d)
    cos, sin = rope_tables(dh, feat, ws / feat)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, dh, cos, sin)
    cases.append((long_attention_rope_packed, long_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:427"))
    e, edh = cfg.d_model, cfg.d_model // cfg.enc_heads
    args = (randn(n_prompts, feat * feat, e), randn(n_prompts, feat * feat, e),
            randn(n_prompts, feat * feat, e), edh ** -0.5, edh)
    cases.append((long_attention_packed, long_attention_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:406"))
    return cases


def _split(entry, args):
    """Entry-point arguments -> (q, k, v, scale, head_dim, cos, sin)."""
    if entry is window_attention_rope_packed:
        q, k, v, scale, cos, sin = args
        return q, k, v, scale, 2 * cos.shape[-1], cos, sin
    if entry is long_attention_rope_packed:
        return args
    return (*args, None, None)


def roofline(t_ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the seconds the operations take at
    the card's peak for their type and the bytes over its memory rate."""
    t_bytes = nbytes / MEM_RATE
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def attention_work(q, head_dim: int, backward: bool):
    """(operations, bytes) of one attention call on (N, L, P*dh) operands:
    4*L^2*dh per batch-head forward (QK^T and PV), 2.5x that backward; q, k,
    v (and o, do, the fp32 lse) read once, o (dq, dk, dv) written once."""
    n, l, pd = q.shape
    elems = n * l * pd
    ops = 4.0 * l * l * head_dim * n * (pd // head_dim)
    if backward:
        return 2.5 * ops, 8 * elems * 2 + n * (pd // head_dim) * l * 4
    return ops, 4 * elems * 2


def sdpa_heads(q, k, v, head_dim, cos, sin):
    """(N, P, L, dh) contiguous q, k (rotated) and v for the library's
    scaled_dot_product_attention."""
    qh, kh, vh = (attention_kernel._heads(t, head_dim) for t in (q, k, v))
    if cos is not None:
        qh, kh = (attention_kernel.apply_rope_half(t, cos, sin) for t in (qh, kh))
    return qh.contiguous(), kh.contiguous(), vh.contiguous()


def phase_kernels(g: torch.Generator, n_prompts: int):
    rows, failed = [], []
    for entry, plain, args, replaces in main_path_operands(g, 1, n_prompts):
        out = entry(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        bound = KERNEL_RTOL * ref.float().abs().max().item()
        ms = median_ms(lambda: entry(*args))
        plain_ms = median_ms(lambda: plain(*args), reps=5)
        q, k, v, scale, dh, cos, sin = _split(entry, args)
        ops, nbytes = attention_work(q, dh, False)
        bound_ms, bound_by = roofline(ops / PEAK_BF16, nbytes)
        qh, kh, vh = sdpa_heads(q, k, v, dh, cos, sin)
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        del qh, kh, vh
        print(f"kernel {entry.__name__} q{tuple(args[0].shape)} stride{args[0].stride()}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|), "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, roofline {bound_ms:.4f} ms "
              f"({bound_by}), scaled_dot_product_attention {lib_ms:.4f} ms", flush=True)
        if not err <= bound:
            failed.append(f"{entry.__name__}: max abs err {err:.3e} > {bound:.3e}")
        rows.append({"name": entry.__name__, "route": "cuda", "source": FWD_SOURCE,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    bwd_rows, bwd_failed = phase_backward_kernels(g)
    gemm_rows, gemm_failed = phase_gemm_kernels(g)
    if failed + bwd_failed + gemm_failed:
        raise AssertionError("; ".join(failed + bwd_failed + gemm_failed))
    return rows + bwd_rows + gemm_rows


BWD_REPLACES = {
    "window_attention_rope_packed": "sam3_lora_tpu/ops/window_attention.py:445",
    "long_attention_rope_packed": "sam3_lora_tpu/ops/long_attention.py:218",
    "long_attention_packed": "sam3_lora_tpu/ops/long_attention.py:218",
}


def phase_backward_kernels(g: torch.Generator):
    """The backward kernels on the training path's operands at batch 4 (and
    4 prompts): the forward with its log-sum-exp, then dq/dk/dv from the
    kernels against the plain backward; returns (rows, failures)."""
    rows, failed = [], []
    for entry, _, args, _ in main_path_operands(g, TRAIN_BATCH, TRAIN_BATCH):
        q, k, v, scale, dh, cos, sin = _split(entry, args)
        o, lse = attention_kernel.attention_packed_cuda(q, k, v, scale, dh, cos, sin, with_lse=True)
        do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)
        grads = attention_kernel.attention_packed_bwd_cuda(q, k, v, o, lse, do, scale, dh, cos, sin)
        torch.cuda.synchronize()
        refs = attention_kernel.attention_packed_bwd_plain(q, k, v, o, do, scale, dh, cos, sin)
        qh, kh = (attention_kernel._heads(t, dh) for t in (q, k))
        if cos is not None:
            qh, kh = (attention_kernel.apply_rope_half(t, cos, sin) for t in (qh, kh))
        lse_ref = torch.logsumexp(torch.einsum("npqd,npkd->npqk", qh.float(), kh.float()) * scale, -1)
        lse_err = (lse - lse_ref).abs().max().item()
        del qh, kh, lse_ref
        errs, parts = [], []
        for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
            err = (a.float() - b.float()).abs().max().item()
            bound = KERNEL_BWD_RTOL * b.float().abs().max().item()
            errs.append(err)
            parts.append(f"{name} {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                failed.append(f"{entry.__name__} backward {name}: max abs err {err:.3e} > {bound:.3e}")
        if not lse_err <= LSE_ATOL:
            failed.append(f"{entry.__name__} lse: max abs err {lse_err:.3e} > {LSE_ATOL}")
        del grads, refs
        ms = median_ms(lambda: attention_kernel.attention_packed_bwd_cuda(
            q, k, v, o, lse, do, scale, dh, cos, sin))
        plain_ms = median_ms(lambda: attention_kernel.attention_packed_bwd_plain(
            q, k, v, o, do, scale, dh, cos, sin), reps=3)
        ops, nbytes = attention_work(q, dh, True)
        bound_ms, bound_by = roofline(ops / PEAK_BF16, nbytes)
        # the library's backward on the rotated operands: autograd of one
        # scaled_dot_product_attention call, its forward outside the timing
        qh, kh, vh = (t.requires_grad_(True) for t in sdpa_heads(q, k, v, dh, cos, sin))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = attention_kernel._heads(do, dh).contiguous()
        lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                       retain_graph=True))
        del qh, kh, vh, lib_out, doh
        torch.cuda.empty_cache()
        print(f"kernel {entry.__name__} backward q{tuple(q.shape)} stride{q.stride()}: "
              f"max_abs_err {', '.join(parts)} ({KERNEL_BWD_RTOL} x max|plain|), lse {lse_err:.3e} "
              f"(bound {LSE_ATOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, roofline "
              f"{bound_ms:.4f} ms ({bound_by}), scaled_dot_product_attention backward "
              f"{lib_ms:.4f} ms", flush=True)
        rows.append({"name": entry.__name__ + "_bwd", "route": "cuda", "source": BWD_SOURCE,
                     "replaces": BWD_REPLACES[entry.__name__], "launches": 0,
                     "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    return rows, failed


GEMM_REPLACES = {
    "int8_gemm_wres": "sam3_lora_tpu/ops/gemm_int8.py:246",
    "int8_lora_gemm_wres": "sam3_lora_tpu/ops/gemm_int8.py:151",
    "bf16_gemm_wres_nt": "sam3_lora_tpu/ops/gemm_int8.py:218",
}
GEMM_ENTRIES = (gemm_int8.int8_gemm_wres, gemm_int8.int8_lora_gemm_wres, gemm_int8.bf16_gemm_wres_nt)
GEMM_ROW_CASE = {"int8_gemm_wres": ("fc1", "train"), "int8_lora_gemm_wres": ("fc1", "serve"),
                 "bf16_gemm_wres_nt": ("fc1", "train")}


def gemm_cases():
    """(layer, path, M, K, N) of the int8 GEMMs on the main paths: the ViT's
    at M = 5184 tokens (serving, one image) and 4 x 5184 (training, batch
    4), the text encoder's at 3 prompts x 32 tokens, and a ragged M."""
    cfg = ModelConfig()
    d, hid, w = cfg.vit_dim, cfg.vit_mlp_hidden, cfg.text_width
    vit = {"qkv": (d, 3 * d), "proj": (d, d), "fc1": (d, hid), "fc2": (hid, d)}
    text = {"out_proj": (w, w), "c_fc": (w, 4 * w), "c_proj": (4 * w, w)}
    tokens = cfg.feat_size ** 2
    cases = [(name, path, m, k, n) for path, m in (("serve", tokens), ("train", TRAIN_BATCH * tokens))
             for name, (k, n) in vit.items()]
    cases += [(name, "text", len(PROMPTS[-1]) * cfg.text_context_length, k, n)
              for name, (k, n) in text.items()]
    return cases + [("fc1", "ragged", 1000, d, hid)]


def phase_gemm_kernels(g: torch.Generator):
    """K4 (every case), K5 (the ViT cases, rank 8) and K6 (the ViT cases) on
    the main path's shapes against their plain versions; returns (one JSON
    row per kernel at GEMM_ROW_CASE, failures)."""
    rows, failed = {}, []
    rank = LORA.rank
    for layer, path, m, k, n in gemm_cases():
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        wq, ws = quant.quantize_weight(torch.randn(n, k, generator=g, device="cuda") / k ** 0.5)
        a = (torch.randn(rank, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        b = (0.02 * torch.randn(n, rank, generator=g, device="cuda")).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=g, device="cuda").to(torch.bfloat16)
        w_deq = gemm_int8.dequantize(wq, ws, torch.bfloat16)
        xq = gemm_int8.quant_rows(x)[0]
        yard = {"int_mm_ms": median_ms(lambda: torch._int_mm(xq, wq.t())) if m > 16 else None,
                "bf16_mm_ms": median_ms(lambda: torch.matmul(x, w_deq.t()))}
        calls = [("int8_gemm_wres", (x, wq, ws), gemm_int8.int8_gemm_wres_plain,
                  2.0 * m * k * n / PEAK_INT8, m * k * 2 + n * k + n * 4 + m * n * 2, None)]
        if path != "text":
            calls.append(("int8_lora_gemm_wres", (x, wq, ws, a, b, LORA.scaling),
                          gemm_int8.int8_lora_gemm_wres_plain,
                          2.0 * m * k * n / PEAK_INT8 + 2.0 * m * rank * (k + n) / PEAK_BF16,
                          m * k * 2 + n * k + n * 4 + rank * (k + n) * 2 + m * n * 2, None))
            calls.append(("bf16_gemm_wres_nt", (dy, wq, ws), gemm_int8.bf16_gemm_wres_nt_plain,
                          2.0 * m * k * n / PEAK_BF16, m * n * 2 + n * k + n * 4 + m * k * 2,
                          lambda: torch.matmul(dy, w_deq)))
        for name, args, plain, t_ops, nbytes, library in calls:
            entry = getattr(gemm_int8, name)
            out = entry(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            ref_max = ref.float().abs().max().item()
            if name == "int8_gemm_wres":
                ok, limit = torch.equal(out, ref), "bit-exact"
            else:
                ok, limit = err <= GEMM_RTOL * ref_max, f"bound {GEMM_RTOL * ref_max:.3e}"
            ms = median_ms(lambda: entry(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=3)
            bound_ms, bound_by = roofline(t_ops, nbytes)
            lib_ms = median_ms(library) if library is not None else None
            if lib_ms is not None:
                extra = f"torch.matmul(dy, w_deq) {lib_ms:.4f} ms"
            else:
                int_mm = yard["int_mm_ms"]
                extra = ("yardsticks (not the same function): torch._int_mm "
                         + ("n/a (M <= 16)" if int_mm is None else f"{int_mm:.4f} ms")
                         + f", bf16 torch.matmul {yard['bf16_mm_ms']:.4f} ms")
            print(f"kernel {name} {layer} ({path}) M={m} K={k} N={n}: max_abs_err {err:.3e} "
                  f"({limit}{'' if ok else ' FAILED'}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"roofline {bound_ms:.4f} ms ({bound_by}), {extra}", flush=True)
            if not ok:
                failed.append(f"{name} {layer} M={m}: max abs err {err:.3e} ({limit})")
            if GEMM_ROW_CASE[name] == (layer, path):
                rows[name] = {"name": name, "route": "cuda", "source": GEMM_SOURCE,
                              "replaces": GEMM_REPLACES[name], "launches": 0, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": lib_ms,
                              "shape": f"{layer} M={m} K={k} N={n}",
                              **({} if lib_ms is not None else yard)}
            del out, ref, diff
        del x, wq, ws, a, b, dy, w_deq, xq
        torch.cuda.empty_cache()
    return [rows[e.__name__] for e in GEMM_ENTRIES], failed


def reset_counts():
    for entry in ENTRIES:
        entry.launches = entry.bwd_launches = 0
    for entry in GEMM_ENTRIES:
        entry.launches = 0


def counts():
    """Every kernel's launches since reset_counts: the attention entries'
    forward (and backward, as <name>_bwd) and K4/K5/K6."""
    out = {e.__name__: e.launches for e in ENTRIES}
    out.update({e.__name__ + "_bwd": e.bwd_launches for e in ENTRIES})
    out.update({e.__name__: e.launches for e in GEMM_ENTRIES})
    return out


def model_config(int8: bool) -> ModelConfig:
    return ModelConfig(dtype="bfloat16", base_quant="int8" if int8 else "none")


def phase_slice(g: torch.Generator, int8: bool = False):
    """Serving at the full config; with ``int8`` the base is in the int8 tier
    and GEMM_LORA_FUSED is on. Returns (launches, latencies, peak bytes)."""
    tag = "slice-int8" if int8 else "slice"
    gemm_int8.GEMM_LORA_FUSED = int8
    t0 = time.perf_counter()
    engine = SAM3LoRAInference(model_config(int8), LORA, seed=SEED, device="cuda")
    n_adapters = 0
    with torch.no_grad():
        for m in engine.model.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.02, generator=g)  # the adapter branch is live
                n_adapters += 1
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    n_int8 = sum(p.dtype == torch.int8 for p in engine.model.parameters())
    print(f"{tag}: built {n_params} params ({n_adapters} adapters, {n_int8} int8 weights) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    image = np.random.RandomState(SEED).randint(0, 256, (900, 1200, 3)).astype(np.uint8)
    engine.predict(image, ["warm-up"])  # first call: allocator, cuDNN and kernel set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = []
    for prompts in PROMPTS:
        t0 = time.perf_counter()
        results = engine.predict(image, prompts)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        if sorted(results) != list(range(len(prompts))):
            raise AssertionError(f"predict returned keys {sorted(results)}")
        for res in results.values():
            n = res["num_detections"]
            if n and (res["boxes"].shape != (n, 4) or res["masks"].shape != (n, 900, 1200)
                      or not np.isfinite(res["boxes"]).all()
                      or not np.isfinite(res["scores"]).all()):
                raise AssertionError(f"bad detections for {res['prompt']!r}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    n_req = len(PROMPTS)
    cfg = engine.cfg
    n_global = len(cfg.vit_global_blocks)
    expected = dict.fromkeys(launches, 0)
    expected.update({"window_attention_rope_packed": (cfg.vit_depth - n_global) * n_req,
                     "long_attention_rope_packed": n_global * n_req,
                     "long_attention_packed": cfg.enc_layers * n_req})
    if int8:
        # per request: the adapted qkv/fc1/fc2 of every ViT block take K5;
        # proj and the text encoder's out_proj/c_fc/c_proj take K4
        expected["int8_lora_gemm_wres"] = 3 * cfg.vit_depth * n_req
        expected["int8_gemm_wres"] = (cfg.vit_depth + 3 * cfg.text_layers) * n_req
    print(f"{tag}: latency per request (s) {[round(t, 4) for t in latencies]} for "
          f"{[len(p) for p in PROMPTS]} prompts, peak {peak / 2**30:.3f} GiB, "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches} != expected {expected}")

    # raw outputs of the last request: finite and of the right shape
    img, _ = engine.preprocess(image)
    ids = engine.tokenizer(PROMPTS[-1], context_length=cfg.text_context_length)
    scores, presence, boxes, masks = engine._forward(
        torch.from_numpy(img).cuda(), torch.from_numpy(np.asarray(ids, np.int64)).cuda())
    b, q, m = len(PROMPTS[-1]), cfg.num_queries, cfg.feat_size * 4
    for name, t, shape in (("scores", scores, (b, q)), ("presence", presence, (b,)),
                           ("boxes", boxes, (b, q, 4)), ("masks", masks, (b, q, m, m))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or non-finite")
    del engine
    torch.cuda.empty_cache()
    gemm_int8.GEMM_LORA_FUSED = False
    return launches, latencies, peak


class SyntheticSamples:
    """Seeded random samples as ``COCOSegmentDataset.load`` gives them: a
    uint8 image at the model's input size, 1-6 boxes (at most
    ``max_targets``) with box-shaped masks at the mask-loss resolution."""

    def __init__(self, cfg: ModelConfig, n: int, seed: int):
        self.cfg, self.n, self.seed = cfg, n, seed

    def __len__(self) -> int:
        return self.n

    def load(self, i: int, epoch: int = 0) -> Sample:
        rng = np.random.RandomState(self.seed * 1000 + i)
        r, t, m = self.cfg.img_size, self.cfg.max_targets, self.cfg.mask_loss_resolution
        boxes = np.zeros((t, 4), np.float32)
        valid = np.zeros((t,), bool)
        masks = np.zeros((t, m, m), bool)
        for j in range(min(rng.randint(1, 7), t)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            w, h = rng.uniform(0.05, 0.3, 2)
            boxes[j], valid[j] = (cx, cy, w, h), True
            x0, x1 = int((cx - w / 2) * m), int(np.ceil((cx + w / 2) * m))
            y0, y1 = int((cy - h / 2) * m), int(np.ceil((cy + h / 2) * m))
            masks[j, y0:y1, x0:x1] = True
        return Sample(image=rng.randint(0, 256, (3, r, r), dtype=np.uint8), text="crack",
                      boxes=boxes, valid=valid, masks=masks, mask_valid=valid.copy(),
                      is_exhaustive=True)


def phase_train(g: torch.Generator, int8: bool = False):
    """Trainer.fit over TRAIN_STEPS batches of TRAIN_BATCH at the full config;
    with ``int8`` the base is in the int8 tier and GEMM_BWD_KERNEL is on.
    Returns (launches, step times, peak bytes)."""
    tag = "train-int8" if int8 else "train"
    gemm_int8.GEMM_BWD_KERNEL = int8
    cfg = model_config(int8)
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = TrainConfig(batch_size=TRAIN_BATCH, num_epochs=1, warmup_steps=0, logging_steps=1,
                           num_workers=2, seed=SEED, output_dir=out_dir)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, LORA, tcfg, device="cuda")
        loader = DataLoader(SyntheticSamples(cfg, TRAIN_BATCH * TRAIN_STEPS, SEED), TRAIN_BATCH,
                            shuffle=False, num_workers=2)
        stats = trainer.setup(steps_per_epoch=len(loader))
        with torch.no_grad():
            for m in trainer.model.modules():
                if isinstance(m, LoRALinear) and m.lora_b is not None:
                    m.lora_b.normal_(0.0, 0.02, generator=g)  # the adapter branch is live
        torch.cuda.synchronize()
        print(f"train: built {stats['total_parameters']} params "
              f"({stats['trainable_parameters']} trainable) in {time.perf_counter() - t0:.2f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        result = trainer.fit(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out_dir, "train_stats.json")) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    times = [r["step_time_s"] for r in records]
    print(f"{tag}: {result['steps']} steps of batch {TRAIN_BATCH} in {wall:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}; step time (s) {times} (first is the warm-up); "
          f"peak {peak / 2**30:.3f} GiB; launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    s = TRAIN_STEPS
    # windowed ViT blocks and fusion-encoder layers run under remat: forward,
    # replay in the backward, then one backward each; global blocks once
    want = dict.fromkeys(launches, 0)
    want.update({"window_attention_rope_packed": 2 * n_win * s, "long_attention_rope_packed": n_global * s,
                 "long_attention_packed": 2 * cfg.enc_layers * s,
                 "window_attention_rope_packed_bwd": n_win * s,
                 "long_attention_rope_packed_bwd": n_global * s,
                 "long_attention_packed_bwd": cfg.enc_layers * s})
    if int8:
        # K4: the 4 GEMMs of every ViT block, again in the windowed blocks'
        # replays, and the text encoder's 3 per layer; K6: the dx of every
        # block's GEMMs that pass the width gate (fc1, fc2), once per step
        # (the text encoder has no adapters, so no gradient flows through it)
        d, hid = cfg.vit_dim, cfg.vit_mlp_hidden
        vit_kn = ((d, 3 * d), (d, d), (d, hid), (hid, d))
        m = TRAIN_BATCH * cfg.feat_size ** 2
        want["int8_gemm_wres"] = (4 * cfg.vit_depth + 4 * n_win + 3 * cfg.text_layers) * s
        want["bf16_gemm_wres_nt"] = cfg.vit_depth * s * sum(
            gemm_int8.supported_nt(m, k, n) for k, n in vit_kn)
    if result["steps"] != s or len(losses) != s or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {result['steps']} steps, losses {losses}")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    del trainer
    torch.cuda.empty_cache()
    gemm_int8.GEMM_BWD_KERNEL = False
    return launches, times, peak


def small_models(int8: bool):
    """A config small enough for the CPU, with the heads of the full model
    (ViT 2 x 64, encoder 4 x 32) so the kernels sit on the path: fp32 on the
    CPU and bf16 on the card, same weights, live adapters. With ``int8`` its
    ViT GEMMs alone are in the int8 tier, as in the full config
    (base_quant_min_dim at the ViT width; d_model 64, 2 heads x 32, keeps the
    geometry encoder's 66-wide projection under the gate), the base quantized
    on each side from the same fp32 weights."""
    widths = dict(vit_dim=128, vit_heads=2, d_model=128, enc_heads=4)
    if int8:
        widths.update(d_model=64, enc_heads=2, base_quant="int8", base_quant_min_dim=128)
    cfg = tiny_model_config(flash_attention_min_seq=16, **widths)
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))
    cpu = build_sam3_image_model(cfg, lora=lora, device="cpu")
    init_model(cpu, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(SEED + 1))
    gpu = build_sam3_image_model(cfg.replace(dtype="bfloat16"), lora=lora, device="cuda")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    if int8:
        for model in (cpu, gpu):
            if not quant.prequantize_model(model, cfg.base_quant_min_dim):
                raise AssertionError("the small int8 config quantized no layer")
    return cfg, cpu, gpu


def small_batch(cfg, with_targets: bool):
    from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer
    from sam3_lora_tpu_torch.train.data import collate

    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.standard_normal((1, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    if not with_targets:
        ids = torch.from_numpy(np.asarray(get_default_tokenizer()(
            ["crack", "wall"], context_length=cfg.text_context_length), np.int64))
        return Batch(images, ids, torch.zeros((2,), dtype=torch.long))
    ds = SyntheticSamples(cfg, 2, SEED)
    return collate([ds.load(i) for i in range(2)], cfg=cfg)


def phase_small_reference(int8: bool = False):
    """The small config's eval forward and one training step, the card
    against the CPU; with ``int8`` its ViT in the int8 tier (bounds above)."""
    tag = "small-int8" if int8 else "small"
    grad_rtol = GRAD_RTOL_INT8 if int8 else GRAD_RTOL
    cfg, cpu, gpu = small_models(int8)
    images_batch = small_batch(cfg, with_targets=False)
    with torch.no_grad():
        ref = cpu(images_batch)
        out = gpu(batch_to_device(images_batch, "cuda"))
    errs = {
        "boxes": (out["pred_boxes"].float().cpu() - ref["pred_boxes"]).abs().max().item(),
        "scores": (torch.sigmoid(out["pred_logits"].float().cpu())
                   - torch.sigmoid(ref["pred_logits"])).abs().max().item(),
        "masks": (torch.sigmoid(out["pred_masks"].float().cpu())
                  - torch.sigmoid(ref["pred_masks"])).abs().max().item(),
    }
    print(f"{tag} reference: max abs err vs CPU fp32 {errs} (bound {SMALL_TOL})", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= SMALL_TOL}
    if bad:
        raise AssertionError(f"{tag} config disagrees with the CPU reference: {bad}")

    # one training step: loss, matching and every adapter gradient
    batch = small_batch(cfg, with_targets=True)
    results = []
    for model, b in ((cpu, batch), (gpu, batch_to_device(batch, "cuda"))):
        named = trainable_parameters(model)
        model.train()
        model.dot_prod_scoring.prompt_mlp.drop.rate = 0.0  # the CPU and card RNGs differ
        out = model(b)
        loss = compute_losses(out, b.targets)["core_loss"]
        loss.backward()
        results.append((loss.item(), out["indices"].cpu(),
                        {n: p.grad.float().cpu() for n, p in named}))
    (ref_loss, ref_idx, ref_g), (loss, idx, grads) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    grad_errs = {n: ((grads[n] - ref_g[n]).norm() / ref_g[n].norm()).item() for n in ref_g}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"{tag} train step: loss {loss:.5f} vs CPU fp32 {ref_loss:.5f} (rel {loss_err:.3e}, "
          f"bound {LOSS_RTOL}); matching equal {torch.equal(idx, ref_idx)}; adapter grads "
          f"rel err max {grad_errs[worst]:.3e} ({worst}), median "
          f"{statistics.median(grad_errs.values()):.3e} (bound {grad_rtol})", flush=True)
    if not torch.equal(idx, ref_idx):
        raise AssertionError("the card's matching differs from the CPU's")
    if not loss_err <= LOSS_RTOL or not grad_errs[worst] <= grad_rtol:
        raise AssertionError(f"{tag} training step disagrees: loss {loss_err:.3e}, "
                             f"grad {grad_errs[worst]:.3e}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _cuda.build()
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = phase_kernels(g, n_prompts=len(PROMPTS[-1]))
    serve, lat, serve_peak = phase_slice(g)
    serve8, lat8, serve_peak8 = phase_slice(g, int8=True)
    train, steps, train_peak = phase_train(g)
    train8, steps8, train_peak8 = phase_train(g, int8=True)
    print(f"int8 tier against bf16 (this call): serving latency (s) {[round(t, 4) for t in lat8]} "
          f"vs {[round(t, 4) for t in lat]}, peak {serve_peak8 / 2**30:.3f} vs "
          f"{serve_peak / 2**30:.3f} GiB; training step (s) {steps8[1:]} vs {steps[1:]} after "
          f"warm-up, peak {train_peak8 / 2**30:.3f} vs {train_peak / 2**30:.3f} GiB", flush=True)
    for row in rows:
        name = row["name"]
        if name in ("int8_gemm_wres", "int8_lora_gemm_wres"):
            row["launches"] = serve8[name] + train8[name]
        elif name == "bf16_gemm_wres_nt":
            row["launches"] = train8[name]
        else:
            row["launches"] = train[name] if name.endswith("_bwd") else serve[name]
    phase_small_reference()
    phase_small_reference(int8=True)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
