"""Smoke run of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  - the card's name and power limit; TF32 off for fp32 math.
  2. build   - compile csrc/attention_fwd.cu with nvcc.
  3. kernels - each attention entry point's kernel against its plain PyTorch
               version, on the operands the main path hands it, bf16; error
               and median CUDA-event times.
  4. slice   - SAM3LoRAInference at the full 848M config (bf16, seeded random
               weights, nonzero adapters) answers three requests of 1, 2 and
               3 prompts; every output finite and of the right shape; the
               launch counters show the requests ran through the kernels; the
               same code on a small config agrees with its CPU plain path.
Then one JSON line of the kernels, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from sam3_lora_tpu_torch.config import LoRAConfig, ModelConfig, tiny_model_config
from sam3_lora_tpu_torch.inference import SAM3LoRAInference
from sam3_lora_tpu_torch.models import Batch, build_sam3_image_model, init_model
from sam3_lora_tpu_torch.models.layers import LoRALinear
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

SEED = 0
# max |kernel - plain| <= KERNEL_RTOL * max |plain|. Both round an fp32 result
# to bf16 and may land one ulp apart, at most 2**-7 of max |plain|; the
# kernel's bf16 P adds less. About 2.5 ulps at the largest output. On an
# H100 (700 W) the errors were 0.22x (K1), 0.24x (K2) and 0.19x (K3) of the
# bound; a copy of the kernel that skipped its second K/V tile erred by
# 27x, 13x and 14x of it.
KERNEL_RTOL = 2e-2
SMALL_TOL = 5e-2   # bf16 on the card against fp32 on the CPU, through the whole small model
SOURCE = "sam3_lora_tpu_torch/csrc/attention_fwd.cu"
PROMPTS = (["crack"], ["crack", "wall"], ["crack", "wall", "stain"])


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


def phase_kernels(g: torch.Generator, n_prompts: int):
    """Operands as the main path hands them over: q/k/v of the ViT are
    strided views of the (N, L, 3*1024) qkv projection, 16 heads x 64; the
    fusion encoder's are (B_prompts, 5184, 256), 8 heads x 32."""

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    cfg = ModelConfig()
    d, dh, feat, ws = cfg.vit_dim, cfg.vit_dim // cfg.vit_heads, cfg.feat_size, cfg.vit_window_size
    n_win = (feat // ws) ** 2
    cases = []
    qkv = randn(n_win, ws * ws, 3 * d)
    cos, sin = rope_tables(dh, ws, 1.0)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, cos, sin)
    cases.append((window_attention_rope_packed, window_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/window_attention.py:663"))
    qkv = randn(1, feat * feat, 3 * d)
    cos, sin = rope_tables(dh, feat, ws / feat)
    args = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], dh ** -0.5, dh, cos, sin)
    cases.append((long_attention_rope_packed, long_attention_rope_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:427"))
    e, edh = cfg.d_model, cfg.d_model // cfg.enc_heads
    args = (randn(n_prompts, feat * feat, e), randn(n_prompts, feat * feat, e),
            randn(n_prompts, feat * feat, e), edh ** -0.5, edh)
    cases.append((long_attention_packed, long_attention_packed_plain, args,
                  "sam3_lora_tpu/ops/long_attention.py:406"))

    rows, failed = [], []
    for entry, plain, args, replaces in cases:
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
        rows.append({"name": entry.__name__, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms})
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def phase_slice(g: torch.Generator):
    lora = LoRAConfig(target_modules=("qkv", "fc1", "fc2", "linear1", "linear2"))
    t0 = time.perf_counter()
    engine = SAM3LoRAInference(ModelConfig(dtype="bfloat16"), lora, seed=SEED, device="cuda")
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
    entries = (window_attention_rope_packed, long_attention_rope_packed, long_attention_packed)
    for entry in entries:
        entry.launches = 0
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
    launches = {e.__name__: e.launches for e in entries}
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
    return launches


def phase_small_reference():
    """A config small enough for the CPU, with the heads of the full model
    (ViT 2 x 64, encoder 4 x 32) so the kernels sit on the path: bf16 on the
    card against fp32 plain versions on the CPU, same weights and inputs."""
    cfg = tiny_model_config(vit_dim=128, vit_heads=2, d_model=128, enc_heads=4,
                            flash_attention_min_seq=16)
    lora = LoRAConfig(rank=4, alpha=8.0, target_modules=("qkv", "fc1", "linear1"))
    cpu = build_sam3_image_model(cfg, lora=lora, device="cpu")
    init_model(cpu, torch.Generator().manual_seed(SEED))
    gpu = build_sam3_image_model(cfg.replace(dtype="bfloat16"), lora=lora, device="cuda")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.standard_normal((1, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    from sam3_lora_tpu_torch.models.tokenizer import get_default_tokenizer

    ids = torch.from_numpy(np.asarray(get_default_tokenizer()(
        ["crack", "wall"], context_length=cfg.text_context_length), np.int64))
    img_ids = torch.zeros((2,), dtype=torch.long)
    with torch.no_grad():
        ref = cpu(Batch(images, ids, img_ids))
        out = gpu(Batch(images.cuda(), ids.cuda(), img_ids.cuda()))
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
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_small_reference()

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
