"""Head-pair-packed window-attention candidates, forward and backward.

Port of ``scripts/probe_packed.py``, on the (N, L, 128) layout that holds two
64-wide heads side by side, read through its (N, 2, L, 64) view:

    copy packed           o = q with K1's loads over the pair layout
    fwd slice wpp 1, 2    the per-head forward (the full rung) on the pair
                          view: a CTA walks the 2 (4) heads of 1 (2) pairs
    fwd blockdiag wpp 1   the block-diagonal pair form: one 128-deep
                          contraction per pair, half its products zeros
    bwd slice             the backward on the pair view: the port's
                          attention backward kernel (csrc/attention_bwd.cu),
                          which reads q, k, v, do and the forward's o and
                          log-sum-exp, and has its own CTA shape, so the
                          script's wpp 1 and 2 are one row here

and ``check``, both forward forms against the per-head math on 4 pairs (the
script's own check).

Run on the card:  python -m sam3_lora_tpu_torch.probes.packed
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..measure import PEAK_BF16, attention_work, median_ms, roofline, timed
from ..ops import attention_kernel
from ..ops import probe_kernels as pk
from . import BWD_SOURCE, D, L, compare, n_heads, pair_view, randn, row, run_cli, stage_row

SCRIPT = "scripts/probe_packed.py"
# (row, stage, pair form, work per CTA, yardstick, line of the JAX body)
FORWARD = (
    ("copy_packed", "copy", True, 1, "copy", 75),
    ("fwd_slice_wpp1", "full", False, 2, "sdpa", 79),
    ("fwd_slice_wpp2", "full", False, 4, "sdpa", 79),
    ("fwd_blockdiag_wpp1", "full", True, 1, "sdpa", 87),
)
BWD_LINE = 152
CHECK_PAIRS = 4  # the script's correctness check: (4, L, 128)


def operands(g: torch.Generator, n_pairs: int, count: int = 3):
    """``count`` (n_pairs, L, 128) bf16 tensors, as their (N, 2, L, 64) pair views."""
    return [pair_view(randn(g, n_pairs, L, 2 * D)) for _ in range(count)]


def rows(g: torch.Generator, batch: int = 8, reps: int = 30, device: str = "cuda") -> List[Dict]:
    q, k, v = operands(g, n_heads(batch) // 2)
    out = [stage_row(f"probe_packed.{name}", f"{SCRIPT}:{line}", q, k, v, stage, reps, device,
                     pair=pair, wpc=wpc, library=lib)
           for name, stage, pair, wpc, lib, line in FORWARD]
    out.append(bwd_row(g, q, k, v, reps, device))
    return out


def bwd_row(g: torch.Generator, q, k, v, reps: int, device: str) -> Dict:
    """The backward on the pair view, its gradients against the plain
    version's on the same operands (the worst of the three, each within
    KERNEL_BWD_RTOL of its largest)."""
    scale = D ** -0.5
    (do,) = operands(g, q.shape[0], 1)
    o = lse = None
    if device != "cpu":  # the forward's output and log-sum-exp, set-up for the kernel
        o, lse = attention_kernel.attention_cuda(q, k, v, scale, with_lse=True)
    before = pk.pair_bwd.launches["bwd"]
    ms, grads = timed(lambda: pk.pair_bwd(q, k, v, o, lse, do, scale), reps, device)
    launches = pk.pair_bwd.launches["bwd"] - before
    plain_ms, refs = timed(lambda: pk.pair_bwd_plain(q, k, v, do, scale), min(reps, 3), device)
    check = max((compare(a, b, "bwd") for a, b in zip(grads, refs)), key=lambda c: c[0] / c[1])
    del grads, refs
    ops, nbytes = attention_work(q.shape[0] * q.shape[1], L, D, backward=True)
    qh, kh, vh = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    doh = do.contiguous()
    lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh, retain_graph=True),
                       reps, device)
    bound = roofline(ops / PEAK_BF16, nbytes) if device != "cpu" else (None, None)
    return row("probe_packed.bwd_slice", f"{SCRIPT}:{BWD_LINE}", "bwd", ms, plain_ms, ops, nbytes,
               bound, lib_ms, "scaled_dot_product_attention backward", check, launches,
               source=BWD_SOURCE)


def check(g: torch.Generator) -> Dict[str, tuple]:
    """The script's check (P-c): both forward forms on 4 pairs against the
    per-head math, within KERNEL_RTOL."""
    q, k, v = operands(g, CHECK_PAIRS)
    scale = D ** -0.5
    ref = pk.stage_plain(q, k, v, "full", scale)  # the per-head math
    return {f"probe_packed.check_{name}": compare(pk.stage(q, k, v, "full", scale, pair, wpc),
                                                  ref, "rtol")
            for name, pair, wpc in (("slice", False, 2), ("blockdiag", True, 1))}


def main(argv=None) -> List[Dict]:
    return run_cli(sys.modules[__name__], argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
