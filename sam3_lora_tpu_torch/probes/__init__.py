"""Probes of the window-attention forward on the card: where K1's time goes.

Ports of the JAX package's Pallas probes, each runnable as a module:

* ``python -m sam3_lora_tpu_torch.probes.window_cost``: the stage ladder
  (copy .. full, the bf16-score and block-diagonal pair forms) and the
  op-rate probes (``scripts/probe_window_cost.py``);
* ``python -m sam3_lora_tpu_torch.probes.dma_floor``: the copy and full
  forward at 1-8 heads (pairs) per CTA (``scripts/probe_dma_floor.py``);
* ``python -m sam3_lora_tpu_torch.probes.packed``: the head-pair-packed
  (N, L, 128) forward, split per head or block-diagonal, and its backward
  (``scripts/probe_packed.py``).

Each takes ``--batch`` (``B``, default 8: the bench batch, 72 windows x 16
heads x 576 tokens x 64), ``--reps`` (``REPS``, default 30) and ``--device``
(``cuda``; ``cpu`` runs the plain versions, for a rehearsal). Each line gives
a probe's median CUDA-event time (host time on the CPU), its rates, its error
against the plain version on the same operands (the timed call's output
against the plain call's), its launches, its roofline bound and a PyTorch
yardstick. ``rows(g, batch, reps, device)`` returns the same lines as dicts
(``chip_smoke.py`` calls it); ``packed.check(g)`` adds the script's
correctness check of the pair forms.

This module holds what the three share: operands, timed rows, bounds and the
comparison rules.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Dict, List, Optional

import torch

from ..measure import (
    KERNEL_BWD_RTOL, KERNEL_RTOL, PEAK_BF16, attention_work, median_ms, roofline, timed,
)
from ..ops import probe_kernels as pk

L, D, HEADS = 576, 64, 16  # tokens per window, head width, heads
WINDOWS_PER_IMAGE = 9
OP_RTOL = 1e-5  # the fp32 op rows, relative to max |plain|
SOURCE = "sam3_lora_tpu_torch/csrc/probe_window.cu"
BWD_SOURCE = "sam3_lora_tpu_torch/csrc/attention_bwd.cu"


def parse_args(argv, description: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=int(os.environ.get("B", "8")),
                    help="images; 9 windows x 16 heads each (env B, default 8)")
    ap.add_argument("--reps", type=int, default=int(os.environ.get("REPS", "30")),
                    help="timed runs per probe, median taken (env REPS, default 30)")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu to rehearse")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the probes time the card: no CUDA device (use --device cpu to rehearse)")
    return args


def randn(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=g, device=g.device).to(torch.bfloat16)


def n_heads(batch: int) -> int:
    """Head-windows of a batch of images."""
    return batch * WINDOWS_PER_IMAGE * HEADS


def pair_view(t: torch.Tensor) -> torch.Tensor:
    """(N, L, 128) head-pair-packed -> its (N, 2, L, 64) view."""
    n, l, w = t.shape
    return t.view(n, l, 2, w // 2).transpose(1, 2)


def compare(got: torch.Tensor, ref: torch.Tensor, rule: str):
    """(max abs error, its limit, ok) of ``got`` against the plain ``ref``:
    rule "exact" (bit for bit), "rtol" (KERNEL_RTOL), "bwd"
    (KERNEL_BWD_RTOL), "op32" (OP_RTOL) or "bf16" (one bf16 ulp of
    max |plain|), all relative to max |plain|."""
    diff = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    if rule == "exact":
        return diff, 0.0, torch.equal(got, ref)
    if rule == "bf16":
        limit = 2.0 ** (torch.tensor(top).log2().floor().item() - 7)
    else:
        limit = {"rtol": KERNEL_RTOL, "bwd": KERNEL_BWD_RTOL, "op32": OP_RTOL}[rule] * top
    return diff, limit, diff <= limit


def row(name: str, replaces: str, variant: Optional[str], ms: float, plain_ms: float,
        ops: float, nbytes: float, bound: tuple, library_ms: Optional[float], library: str,
        check: tuple, launches: int, source: str = SOURCE, **extra) -> Dict:
    """One probe's line, as chip_smoke's ``kernels`` rows have it, with its
    comparison ``check`` (max abs error, limit, ok) and the launches of its
    timed runs."""
    bound_ms, bound_by = bound
    err, limit, ok = check
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "variant": variant, "launches": launches, "max_abs_err": err, "limit": limit,
            "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": library, "ops": ops, "bytes": nbytes, **extra}


def format_check(name: str, c: tuple) -> str:
    e, limit, ok = c
    return (f"{name:32s} err {e:.3e} "
            f"({'bit-exact' if limit == 0.0 else f'limit {limit:.3e}'}{'' if ok else ' FAILED'})")


def format_row(r: Dict) -> str:
    ms = r["ms"]
    rates = []
    if r.get("elems"):
        rates.append(f"{r['elems'] / ms / 1e6:8.2f} Gelem/s")
    else:
        if r["ops"]:
            rates.append(f"{r['ops'] / ms / 1e9:7.1f} TF/s")
        rates.append(f"{r['bytes'] / ms / 1e6:7.1f} GB/s")
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms ({r['library']})"
    bound = "not measured" if r["bound_ms"] is None else f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
    extra = ""
    if "attention_cuda_ms" in r:
        extra = (f" | in turns: rung {r['full_paired_ms']:.4f} ms, attention_cuda "
                 f"{r['attention_cuda_ms']:.4f} ms, "
                 f"{'bit for bit' if r['equals_attention_cuda'] else 'DIFFERS'}")
    err = format_check("", (r["max_abs_err"], r["limit"], r["ok"])).strip()
    return (f"{r['name']:32s} {ms:9.4f} ms  {'  '.join(rates)} | {err} | "
            f"launches {r['launches']} | bound {bound} | plain {r['plain_ms']:.4f} ms | "
            f"library {lib}{extra}")


def device_line(device: str) -> str:
    if device == "cpu":
        return "device: cpu (plain versions; host times, no device metric)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return f"device: {torch.cuda.get_device_name(0)} | {smi}"


def run_cli(module, argv, description: str) -> List[Dict]:
    """A probe module's main: its rows, one line each, then the module's
    extra checks (``check``, where it has one)."""
    args = parse_args(argv, description)
    print(device_line(args.device), flush=True)
    rows = module.rows(torch.Generator(device=args.device).manual_seed(0), args.batch, args.reps,
                       args.device)
    for r in rows:
        print(format_row(r), flush=True)
    checks = {}
    if hasattr(module, "check"):
        checks = module.check(torch.Generator(device=args.device).manual_seed(1))
    for name, c in checks.items():
        print(format_check(name, c), flush=True)
    bad = [r["name"] for r in rows if not r["ok"]] + [n for n, c in checks.items() if not c[2]]
    if bad:
        raise SystemExit(f"probes disagree with their plain versions: {bad}")
    return rows


def stage_row(name: str, replaces: str, q, k, v, stage: str, reps: int, device: str,
              pair: bool = False, wpc: int = 1, library: Optional[str] = None,
              o: Optional[torch.Tensor] = None) -> Dict:
    """Time one stage kernel on (N, P, L, 64) views at the probe's batch
    (writing ``o``, or a new tensor), and its plain version on the same
    operands; hold the timed output against the plain one (copies bit for
    bit, the rest within KERNEL_RTOL). The yardstick ``library``: "copy" (a
    device copy of the same bytes), "bmm" (two torch.bmm, S then S V),
    "sdpa" (scaled_dot_product_attention) or None."""
    scale = D ** -0.5
    if o is None:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    variant = pk.variant(stage, pair, wpc)
    before = pk.stage.launches[variant]
    ms, _ = timed(lambda: pk.stage(q, k, v, stage, scale, pair, wpc, o=o), reps, device)
    launches = pk.stage.launches[variant] - before
    plain_ms, ref = timed(lambda: pk.stage_plain(q, k, v, stage, scale), min(reps, 3), device)
    check = compare(o, ref, "exact" if stage == "copy" else "rtol")
    del ref
    n_heads = q.shape[0] * q.shape[1]
    ops, nbytes = attention_work(n_heads, L, D, backward=False)
    if stage == "copy":
        ops = 0.0
    lib_ms = None
    if library == "copy":
        src = torch.empty(2 * q.numel(), dtype=q.dtype, device=q.device)
        dst = torch.empty_like(src)
        lib_ms = median_ms(lambda: dst.copy_(src), reps, device)
        library = "tensor.copy_ of the same bytes"
    elif library == "bmm":
        qb, kb, vb = (t.reshape(n_heads, L, D) for t in (q, k, v))
        kt = kb.transpose(1, 2)
        lib_ms = median_ms(lambda: torch.bmm(torch.bmm(qb, kt), vb), reps, device)
        library = "two torch.bmm"
    elif library == "sdpa":
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lib_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, scale=scale), reps, device)
        library = "scaled_dot_product_attention"
    bound = roofline(ops / PEAK_BF16, nbytes) if device != "cpu" else (None, None)
    return row(name, replaces, variant, ms, plain_ms, ops, nbytes, bound, lib_ms,
               library or "none", check, launches)
