"""A/B of checkouts of the port on one card: the int8 tier's K4 and K6
against their PyTorch yardsticks at fc1, the attention forward and backward
at bench.py's batch against scaled_dot_product_attention's, and three
training phases of each checkout, each with one profiled step.

    python sam3_lora_tpu_torch/probes/step_ab.py --trees _proof/parent . . _proof/parent --out ab.jsonl

Each tree runs in a process of its own (the checkouts share the package's
name), builds its own kernels from its own sources and trains with its own
``Trainer`` on ``chip_smoke.py``'s samples; the profile is this checkout's
``measure.profile_step`` whatever the tree. Per run it prints, and appends to
``--out`` as one JSON line:

* ``gemm``: at qkv, fc1 and fc2 with M = 5184 (one image), at fc1 with
  M = 20736 (batch 4) and 41472 (bench.py's batch 8), the median CUDA-event
  ms of the tree's K4, K5 (rank 8, scale 2) and K6 wrappers, the unfused
  chain (K4, the two adapter products, the add), ``torch._int_mm`` on the
  same int8 operands, bf16 ``torch.matmul`` of x against the dequantized
  weight and ``torch.matmul(dy, w_deq)``; the device us a call of K4, K5
  and K6 (all their kernels, one profile of 10 calls each); K4 held bit for
  bit to its plain version;
* ``fwd``: the tree's ``attention_packed_cuda`` with ``with_lse`` (as
  training calls it) at bench.py's batch 8: K1 (72 windows x 16 heads x 576
  x 64, RoPE), K2 (8 x 16 x 5184 x 64, RoPE) and K3 (8 x 8 x 5184 x 32): its
  median CUDA-event ms, the device ms of its kernels in one profiled call
  (by kernel: the rotation pass and the main kernel), and one
  ``scaled_dot_product_attention`` call on the same operands rotated
  beforehand, with o's largest difference from the library's;
* ``bwd``: the tree's ``attention_packed_bwd_cuda`` at bench.py's batch 8:
  K1-bwd (72 windows x 16 heads x 576 x 64, RoPE), K2-bwd (8 x 16 x 5184 x
  64, RoPE) and K3-bwd (8 x 8 x 5184 x 32): its median CUDA-event ms, the
  device ms of its kernels in one profiled call (by kernel), and the
  backward of one ``scaled_dot_product_attention`` call on the same (rotated)
  operands, with dv's largest difference from the library's relative to
  max |dv| (dq and dk are taken with respect to other inputs under RoPE);
* ``ops``: the tree's op-rate probe (``probe_kernels.op_rate``) over the
  16-tile (9216 x 576) input, every op at the passes this checkout's
  ``window_cost.op_passes`` gives it (the same in every tree): its median
  CUDA-event ms and a digest of its output's bits; and a digest of one
  fast_exp2_f32 pass over 2^x's range ([-300, 300], the x.5 ties, the clamp
  edges), so two trees' fast_exp2 lowerings are held bit for bit;
* ``train``, ``train_int8``, ``bench``: chip_smoke's train phase at batch 4
  (bf16; the int8 tier with ``GEMM_BWD_KERNEL`` on) and bench-train at batch
  8 (``bench_model_config``, ``bench_lora_config``): four steps (the first
  is the warm-up) and the profile of a fifth: device ms by kernel, K4's,
  K6's and the attention forward's and backward's kernels' sums, the busy
  share.

Seeds are fixed, so every tree sees the same operands and samples.
``--phases`` runs a subset (``--phases gemm`` or ``--phases ops`` takes a
few seconds a tree after its build).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# K4's and K6's kernels by the name the profiler gives them: the TMA/wgmma
# mainloop and its first pass, or the mma.sync kernels of the first design
K4_KERNELS = ("S8Scaled", "quant_rows_kernel", "int8_gemm_kernel<false>")
K6_KERNELS = ("Bf16Plain", "dequant_t_kernel", "bf16_gemm_nt_kernel")
# the attention backward's kernels: the prep pass and the TMA/wgmma passes,
# or the first design's row dot and mma.sync passes
BWD_KERNELS = ("bwd_prep_kernel", "rowdot_kernel", "dkdv_kernel", "dq_kernel")
# the attention forward's kernels: the rotation pass and the main kernel
# (the first design's one kernel has the main kernel's name)
FWD_KERNELS = ("rope_kernel", "attention_fwd_kernel")
FWD_CASES = (("K1", 72, 576, 16, 64, True), ("K2", 8, 5184, 16, 64, True),
             ("K3", 8, 5184, 8, 32, False))
BWD_CASES = (("K1-bwd", 72, 576, 16, 64, True), ("K2-bwd", 8, 5184, 16, 64, True),
             ("K3-bwd", 8, 5184, 8, 32, False))
STEPS = 4
TOP = 15


def _profile_step():
    """This checkout's ``measure.profile_step``, loaded by path: the tree
    under test may predate it."""
    spec = importlib.util.spec_from_file_location("_ab_measure", os.path.join(HERE, "..", "measure.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.profile_step


GEMM_CASES = (("qkv", 5184, 1024, 3072), ("fc1", 5184, 1024, 4736), ("fc2", 5184, 4736, 1024),
              ("fc1", 20736, 1024, 4736), ("fc1", 41472, 1024, 4736))


def device_us(profile_step, fn, calls: int = 10) -> float:
    """The device us of one call of ``fn``: every kernel of ``calls`` calls
    in one profile."""
    fn()
    return profile_step(lambda: [fn() for _ in range(calls)])["device_ms"] * 1e3 / calls


def gemm_rows(torch, gemm_int8, quant, median_ms, profile_step):
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for layer, m, k, n in GEMM_CASES:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        wq, ws = quant.quantize_weight(torch.randn(n, k, generator=g, device="cuda") / k ** 0.5)
        dy = torch.randn(m, n, generator=g, device="cuda").to(torch.bfloat16)
        a = (torch.randn(8, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        b = (0.02 * torch.randn(n, 8, generator=g, device="cuda")).to(torch.bfloat16)
        w_deq = gemm_int8.dequantize(wq, ws, torch.bfloat16)
        xq = gemm_int8.quant_rows(x)[0]
        exact = torch.equal(gemm_int8.int8_gemm_wres(x, wq, ws), gemm_int8.int8_gemm_wres_plain(x, wq, ws))

        def unfused():
            delta = torch.nn.functional.linear(torch.nn.functional.linear(x, a).float(), b.float())
            return gemm_int8.int8_gemm_wres(x, wq, ws) + (delta * 2.0).to(x.dtype)

        k4 = lambda: gemm_int8.int8_gemm_wres(x, wq, ws)  # noqa: E731
        k5 = lambda: gemm_int8.int8_lora_gemm_wres(x, wq, ws, a, b, 2.0)  # noqa: E731
        k6 = lambda: gemm_int8.bf16_gemm_wres_nt(dy, wq, ws)  # noqa: E731
        rows.append({"layer": layer, "M": m, "K": k, "N": n, "k4_bit_exact": exact,
                     "k4_ms": median_ms(k4), "k5_ms": median_ms(k5),
                     "k4_device_us": device_us(profile_step, k4),
                     "k5_device_us": device_us(profile_step, k5),
                     "k6_device_us": device_us(profile_step, k6),
                     "unfused_ms": median_ms(unfused),
                     "int_mm_ms": median_ms(lambda: torch._int_mm(xq, wq.t())),
                     "bf16_mm_ms": median_ms(lambda: torch.matmul(x, w_deq.t())),
                     "k6_ms": median_ms(k6),
                     "dy_w_deq_ms": median_ms(lambda: torch.matmul(dy, w_deq))})
        print(json.dumps(rows[-1]), flush=True)
        del x, wq, ws, dy, a, b, w_deq, xq
        torch.cuda.empty_cache()
    return rows


def kernel_sums(prof: dict, names) -> dict:
    """Device ms and launches of a profile's kernels by which of ``names``
    their name holds."""
    out = {}
    for name, (ms, n) in prof["kernels"].items():
        for key in names:
            if key in name:
                ms0, n0 = out.get(key, (0.0, 0))
                out[key] = (ms0 + ms, n0 + n)
    return out


def _operands(torch, g, n, l, p, dh, rope):
    """q, k, v as column views of one (n, l, 3 p dh) qkv tensor, and the
    RoPE tables (random angles) or None."""
    qkv = torch.randn(n, l, 3 * p * dh, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    cos = sin = None
    if rope:
        ang = torch.rand(l, dh // 2, generator=g, device="cuda") * 6
        cos, sin = ang.cos(), ang.sin()
    return q, k, v, cos, sin


def fwd_rows(torch, ak, median_ms, profile_step):
    """The forward at bench.py's batch beside the library's (``fwd`` above)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, n, l, p, dh, rope in FWD_CASES:
        q, k, v, cos, sin = _operands(torch, g, n, l, p, dh, rope)
        scale = dh ** -0.5

        def call():
            return ak.attention_packed_cuda(q, k, v, scale, dh, cos, sin, with_lse=True)

        o = call()[0]
        ms = median_ms(call)
        split = kernel_sums(profile_step(call), FWD_KERNELS)
        qh, kh, vh = (ak._heads(t, dh) for t in (q, k, v))
        if rope:
            qh, kh = (ak.apply_rope_half(t, cos, sin) for t in (qh, kh))
        qh, kh, vh = (t.contiguous() for t in (qh, kh, vh))
        lib = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        o_err = (ak._heads(o, dh).float() - lib.float()).abs().max().item()
        sdpa_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        rows.append({"row": name, "shape": [n, p, l, dh], "rope": rope, "ms": ms,
                     "device_ms": {k: v[0] for k, v in split.items()},
                     "device_total_ms": sum(v[0] for v in split.values()),
                     "sdpa_ms": sdpa_ms, "o_max_abs_diff_vs_sdpa": o_err,
                     "o_max_abs_sdpa": lib.float().abs().max().item()})
        print(json.dumps(rows[-1]), flush=True)
        del q, k, v, o, qh, kh, vh, lib
        torch.cuda.empty_cache()
    return rows


def bwd_rows(torch, ak, median_ms, profile_step):
    """The backward at bench.py's batch beside the library's (``bwd`` above)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, n, l, p, dh, rope in BWD_CASES:
        q, k, v, cos, sin = _operands(torch, g, n, l, p, dh, rope)
        scale = dh ** -0.5
        o, lse = ak.attention_packed_cuda(q, k, v, scale, dh, cos, sin, with_lse=True)
        do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)

        def call():
            return ak.attention_packed_bwd_cuda(q, k, v, o, lse, do, scale, dh, cos, sin)

        grads = call()
        ms = median_ms(call)
        split = kernel_sums(profile_step(call), BWD_KERNELS)
        qh, kh, vh, doh = (ak._heads(t, dh) for t in (q, k, v, do))
        if rope:
            qh, kh = (ak.apply_rope_half(t, cos, sin) for t in (qh, kh))
        qh, kh, vh = (t.contiguous().requires_grad_(True) for t in (qh, kh, vh))
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = doh.contiguous()
        lib = torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)
        dv_err = ((ak._heads(grads[2], dh).float() - lib[2].float()).abs().max()
                  / lib[2].float().abs().max()).item()
        sdpa_ms = median_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
        rows.append({"row": name, "shape": [n, p, l, dh], "rope": rope, "ms": ms,
                     "device_ms": {k: v[0] for k, v in split.items()},
                     "device_total_ms": sum(v[0] for v in split.values()),
                     "sdpa_bwd_ms": sdpa_ms, "dv_rel_diff_vs_sdpa": dv_err})
        print(json.dumps(rows[-1]), flush=True)
        del q, k, v, o, lse, do, grads, qh, kh, vh, out, doh, lib
        torch.cuda.empty_cache()
    return rows


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of an fp32 or bf16 tensor's bits."""
    import torch

    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def fexp_input(torch):
    """-v for v over fast_exp2's range: [-300, 300] by 2^-6, the ties k + 0.5,
    the clamp edges and their neighbours, as (rows, 576) fp32 rows."""
    v = torch.cat([torch.arange(-300 * 64, 300 * 64 + 1) / 64.0,
                   torch.arange(-140, 141) + 0.5,
                   torch.tensor([-126.5, -126.0, -125.5, 126.5, 127.0, 127.5, -0.0, 0.0])])
    v = torch.cat([v, v.nextafter(torch.tensor(float("inf"))),
                   v.nextafter(torch.tensor(float("-inf")))])
    v = torch.cat([v, v.new_zeros(-len(v) % 576)])
    return (-v).view(-1, 576).cuda()


def op_rows(torch, pk, median_ms, passes: dict):
    """The op-rate probe of the tree at the given passes (``ops`` above)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x32 = torch.randn(16 * 576, 576, generator=g, device="cuda").abs() + 0.5
    rows = []
    for name, n in passes.items():
        x = x32.to(pk.op_dtype(name))
        y = pk.op_rate(x, name, n)
        rows.append({"op": name, "passes": n, "ms": median_ms(lambda: pk.op_rate(x, name, n)),
                     "digest": digest(y)})
        print(json.dumps(rows[-1]), flush=True)
    rows.append({"op": "fast_exp2_f32 range", "passes": 1,
                 "digest": digest(pk.op_rate(fexp_input(torch), "fast_exp2_f32", 1))})
    print(json.dumps(rows[-1]), flush=True)
    return rows


def op_passes() -> dict:
    """This checkout's passes for each op over the 16-tile input."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from sam3_lora_tpu_torch.ops.probe_kernels import OPS
    from sam3_lora_tpu_torch.probes import window_cost as wc

    sms, clock = wc.n_sms(), wc.sm_clock_hz()
    return {name: wc.op_passes(name, 16 * 576 * 576, sms, clock) for name in OPS}


def profiled_fit(torch, chip_smoke, profile_step, cfg, lora, batch: int) -> dict:
    """STEPS training steps of the tree's Trainer at ``cfg`` and ``batch``,
    adapters drawn live, then a profiled step."""
    from sam3_lora_tpu_torch.config import TrainConfig
    from sam3_lora_tpu_torch.models.layers import LoRALinear
    from sam3_lora_tpu_torch.train.data import DataLoader
    from sam3_lora_tpu_torch.train.prefetch import batch_to_device
    from sam3_lora_tpu_torch.train.trainer import Trainer

    g = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = TrainConfig(batch_size=batch, num_epochs=1, warmup_steps=0, logging_steps=1,
                           num_workers=2, seed=0, output_dir=out_dir)
        trainer = Trainer(cfg, lora, tcfg, device="cuda")
        loader = DataLoader(chip_smoke.SyntheticSamples(cfg, batch * STEPS, 0), batch,
                            shuffle=False, num_workers=2)
        trainer.setup(steps_per_epoch=len(loader))
        with torch.no_grad():
            for m in trainer.model.modules():
                if isinstance(m, LoRALinear) and m.lora_b is not None:
                    m.lora_b.normal_(0.0, 0.02, generator=g)
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(loader)
        with open(os.path.join(out_dir, "train_stats.json")) as f:
            times = [json.loads(line)["step_time_s"] for line in f]
        peak = torch.cuda.max_memory_allocated()
        first = batch_to_device(next(iter(loader.epoch(0))), "cuda")
        prof = profile_step(lambda: trainer.train_step(first))
    del trainer
    torch.cuda.empty_cache()

    def total(names):
        hits = [(ms, n) for name, (ms, n) in prof["kernels"].items() if any(s in name for s in names)]
        return sum(ms for ms, _ in hits), sum(n for _, n in hits)

    (k4_ms, k4_n), (k6_ms, k6_n) = total(K4_KERNELS), total(K6_KERNELS)
    bwd = kernel_sums(prof, BWD_KERNELS)
    fwd = kernel_sums(prof, FWD_KERNELS)
    res = {"step_s": times, "peak_gib": peak / 2 ** 30, "device_ms": prof["device_ms"],
           "window_ms": prof["window_ms"], "busy_share": prof["busy_share"],
           "k4_ms": k4_ms, "k4_launches": k4_n, "k6_ms": k6_ms, "k6_launches": k6_n,
           "fwd_ms": sum(v[0] for v in fwd.values()), "fwd_by_kernel": fwd,
           "bwd_ms": sum(v[0] for v in bwd.values()), "bwd_by_kernel": bwd,
           "top": [(name[:120], ms, n) for name, (ms, n) in list(prof["kernels"].items())[:TOP]]}
    print(json.dumps({k: v for k, v in res.items() if k != "top"}), flush=True)
    return res


PHASES = ("gemm", "fwd", "bwd", "ops", "train", "train_int8", "bench")


def worker(tree: str, out: str, phases, passes=None) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from sam3_lora_tpu_torch.config import bench_lora_config, bench_model_config
    from sam3_lora_tpu_torch.measure import median_ms
    from sam3_lora_tpu_torch.ops import _cuda, gemm_int8, probe_kernels, quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _cuda.build()
    from sam3_lora_tpu_torch.ops import attention_kernel

    profile_step = _profile_step()
    res = {"tree": tree, "device": smi}
    if "gemm" in phases:
        res["gemm"] = gemm_rows(torch, gemm_int8, quant, median_ms, profile_step)
    if "fwd" in phases:
        res["fwd"] = fwd_rows(torch, attention_kernel, median_ms, profile_step)
    if "bwd" in phases:
        res["bwd"] = bwd_rows(torch, attention_kernel, median_ms, profile_step)
    if "ops" in phases:
        res["ops"] = op_rows(torch, probe_kernels, median_ms, passes)
    for phase, cfg, lora, batch in (
            ("train", chip_smoke.model_config(False), chip_smoke.LORA, chip_smoke.TRAIN_BATCH),
            ("train_int8", chip_smoke.model_config(True), chip_smoke.LORA, chip_smoke.TRAIN_BATCH),
            ("bench", bench_model_config(), bench_lora_config(), chip_smoke.BENCH_BATCH)):
        if phase not in phases:
            continue
        gemm_int8.GEMM_BWD_KERNEL = phase == "train_int8"  # as chip_smoke's train-int8
        res[phase] = profiled_fit(torch, chip_smoke, profile_step, cfg, lora, batch)
    gemm_int8.GEMM_BWD_KERNEL = False
    line = json.dumps(res)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to run, in this order")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--op-passes", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="step_ab.jsonl", help="JSON lines, appended")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES),
                    help="what to run in each tree (default: all)")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    if args.worker:
        worker(args.worker, out, args.phases, json.loads(args.op_passes or "null"))
        return
    os.makedirs(os.path.dirname(out), exist_ok=True)
    extra = []
    if "ops" in args.phases:  # one set of passes for every tree
        extra = ["--op-passes", json.dumps(op_passes())]
    for tree in args.trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, "--out", out,
                        "--phases", *args.phases, *extra], check=True)


if __name__ == "__main__":
    main()
