"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  - the card's name and power limit; TF32 off for fp32 math.
  2. build   - compile csrc/attention_fwd.cu and csrc/attention_bwd.cu with
               nvcc (one process per source, in parallel).
  3. kernels - each attention entry point's forward kernel against its plain
               PyTorch version, on the operands the serving path hands it;
               the backward kernels (and the forward's log-sum-exp) against
               attention_packed_bwd_plain on the operands of the training
               path at batch 4; bf16; errors and median CUDA-event times.
  4. slice   - SAM3LoRAInference at the full 848M config (bf16, seeded random
               weights, nonzero adapters) answers three requests of 1, 2 and
               3 prompts; every output finite and of the right shape; the
               launch counters show the requests ran through the kernels.
  5. train   - Trainer.fit at the full config, batch 4, LoRA on qkv, fc1,
               fc2, linear1 and linear2, over seeded random images and
               targets batched by the port's collate: one warm-up and three
               timed steps with finite losses; step times, peak memory, and
               forward and backward launch counts equal to the design's.
  6. small   - a small config whose path runs every kernel: its eval forward
               and one training step (loss, matching and adapter gradients)
               in bf16 on the card against the same in fp32 on the CPU.
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

from sam3_lora_tpu_torch.config import LoRAConfig, ModelConfig, TrainConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models import Batch, build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
from sam3_lora_tpu_torch.models.lora import trainable_parameters
from sam3_lora_tpu_torch.ops import attention_kernel
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
FWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_bwd.cu"
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
        print(f"kernel {entry.__name__} q{tuple(args[0].shape)} stride{args[0].stride()}: "
              f"max_abs_err {err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|), "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if not err <= bound:
            failed.append(f"{entry.__name__}: max abs err {err:.3e} > {bound:.3e}")
        rows.append({"name": entry.__name__, "route": "cuda", "source": FWD_SOURCE,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
    bwd_rows, bwd_failed = phase_backward_kernels(g)
    if failed + bwd_failed:
        raise AssertionError("; ".join(failed + bwd_failed))
    return rows + bwd_rows


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
        torch.cuda.empty_cache()
        print(f"kernel {entry.__name__} backward q{tuple(q.shape)} stride{q.stride()}: "
              f"max_abs_err {', '.join(parts)} ({KERNEL_BWD_RTOL} x max|plain|), lse {lse_err:.3e} "
              f"(bound {LSE_ATOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        rows.append({"name": entry.__name__ + "_bwd", "route": "cuda", "source": BWD_SOURCE,
                     "replaces": BWD_REPLACES[entry.__name__], "launches": 0,
                     "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms})
    return rows, failed


def reset_counts():
    for entry in ENTRIES:
        entry.launches = entry.bwd_launches = 0


def phase_slice(g: torch.Generator):
    t0 = time.perf_counter()
    engine = SAM3LoRAInference(ModelConfig(dtype="bfloat16"), LORA, seed=SEED, device="cuda")
    n_adapters = 0
    with torch.no_grad():
        for m in engine.model.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.02, generator=g)  # the adapter branch is live
                n_adapters += 1
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"slice: built {n_params} params ({n_adapters} adapters) in "
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
    launches = {e.__name__: e.launches for e in ENTRIES}
    peak = torch.cuda.max_memory_allocated()
    n_req = len(PROMPTS)
    cfg = engine.cfg
    n_global = len(cfg.vit_global_blocks)
    expected = {"window_attention_rope_packed": (cfg.vit_depth - n_global) * n_req,
                "long_attention_rope_packed": n_global * n_req,
                "long_attention_packed": cfg.enc_layers * n_req}
    print(f"slice: latency per request (s) {[round(t, 4) for t in latencies]} for "
          f"{[len(p) for p in PROMPTS]} prompts, peak {peak / 2**30:.3f} GiB, "
          f"launches {launches}", flush=True)
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")

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
    return launches


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


def phase_train(g: torch.Generator):
    """Trainer.fit over TRAIN_STEPS batches of TRAIN_BATCH at the full config."""
    cfg = ModelConfig(dtype="bfloat16")
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
        fwd = {e.__name__: e.launches for e in ENTRIES}
        bwd = {e.__name__: e.bwd_launches for e in ENTRIES}
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out_dir, "train_stats.json")) as f:
            records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    times = [r["step_time_s"] for r in records]
    print(f"train: {result['steps']} steps of batch {TRAIN_BATCH} in {wall:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}; step time (s) {times} (first is the warm-up); "
          f"peak {peak / 2**30:.3f} GiB; launches fwd {fwd} bwd {bwd}", flush=True)
    n_global = len(cfg.vit_global_blocks)
    n_win = cfg.vit_depth - n_global
    s = TRAIN_STEPS
    # windowed ViT blocks and fusion-encoder layers run under remat: forward,
    # replay in the backward, then one backward each; global blocks once
    want_fwd = {"window_attention_rope_packed": 2 * n_win * s, "long_attention_rope_packed": n_global * s,
                "long_attention_packed": 2 * cfg.enc_layers * s}
    want_bwd = {"window_attention_rope_packed": n_win * s, "long_attention_rope_packed": n_global * s,
                "long_attention_packed": cfg.enc_layers * s}
    if result["steps"] != s or len(losses) != s or not all(np.isfinite(losses)):
        raise AssertionError(f"train: {result['steps']} steps, losses {losses}")
    if fwd != want_fwd or bwd != want_bwd:
        raise AssertionError(f"train launches fwd {fwd} bwd {bwd}, expected {want_fwd} {want_bwd}")
    del trainer
    torch.cuda.empty_cache()
    return fwd, bwd


def small_models():
    """A config small enough for the CPU, with the heads of the full model
    (ViT 2 x 64, encoder 4 x 32) so the kernels sit on the path: fp32 on the
    CPU and bf16 on the card, same weights, live adapters."""
    cfg = tiny_model_config(vit_dim=128, vit_heads=2, d_model=128, enc_heads=4,
                            flash_attention_min_seq=16)
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))
    cpu = build_sam3_image_model(cfg, lora=lora, device="cpu")
    init_model(cpu, torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, LoRALinear) and m.lora_b is not None:
                m.lora_b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(SEED + 1))
    gpu = build_sam3_image_model(cfg.replace(dtype="bfloat16"), lora=lora, device="cuda")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
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


def phase_small_reference():
    cfg, cpu, gpu = small_models()
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
    print(f"small reference: max abs err vs CPU fp32 {errs} (bound {SMALL_TOL})", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= SMALL_TOL}
    if bad:
        raise AssertionError(f"small config disagrees with the CPU reference: {bad}")

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
    print(f"small train step: loss {loss:.5f} vs CPU fp32 {ref_loss:.5f} (rel {loss_err:.3e}, "
          f"bound {LOSS_RTOL}); matching equal {torch.equal(idx, ref_idx)}; adapter grads "
          f"rel err max {grad_errs[worst]:.3e} ({worst}), median "
          f"{statistics.median(grad_errs.values()):.3e} (bound {GRAD_RTOL})", flush=True)
    if not torch.equal(idx, ref_idx):
        raise AssertionError("the card's matching differs from the CPU's")
    if not loss_err <= LOSS_RTOL or not grad_errs[worst] <= GRAD_RTOL:
        raise AssertionError(f"small training step disagrees: loss {loss_err:.3e}, "
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
    lib = attention_kernel.build()
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s", flush=True)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = phase_kernels(g, n_prompts=len(PROMPTS[-1]))
    launches = phase_slice(g)
    _, bwd = phase_train(g)
    for row in rows:
        name = row["name"]
        row["launches"] = bwd[name[:-4]] if name.endswith("_bwd") else launches[name]
    phase_small_reference()

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
