"""Block-sweep probe of the window-attention forward: work per CTA.

Port of ``scripts/probe_dma_floor.py``. The TPU sweep varied the VMEM block
(heads and windows per program, a lane-packed 128-wide layout) to amortize
per-program overhead. On the card the counterpart is the work per CTA: one
CTA of the stage kernel (``csrc/probe_window.cu``) walks 1, 2, 4 or 8 heads
for its 64 query rows, each through K1's body. Rows:

    copy wpc 1-8          o = q with K1's loads, (n/2, 2, L, 64) operands
    copy pair wpc 1, 4    the same over the head-pair-packed (n/2, L, 128)
                          layout, a 64 x 128 tile per head pair
    copy flat wpc 8       the (n/16, 4608, 128) block: 8 pairs per CTA
    full wpc 1-8          the production forward math, 1-8 heads per CTA

Run on the card:  python -m sam3_lora_tpu_torch.probes.dma_floor
"""

from __future__ import annotations

import sys
from typing import Dict, List

import torch

from . import D, L, n_heads, pair_view, randn, run_cli, stage_row

SCRIPT = "scripts/probe_dma_floor.py"
# (row, stage, pair form, work per CTA, yardstick, line of the JAX body)
SWEEP = (
    [(f"copy_wpc{w}", "copy", False, w, "copy", 58) for w in (1, 2, 4, 8)]
    + [(f"copy_pair_wpc{w}", "copy", True, w, "copy", 58) for w in (1, 4)]
    + [("copy_flat_wpc8", "copy", True, 8, "copy", 58)]
    + [(f"full_wpc{w}", "full", False, w, "sdpa", 62) for w in (1, 2, 4, 8)]
)


def operands(g: torch.Generator, n: int, pair: bool):
    """q, k, v: (n/2, 2, L, 64) heads, or the pair view of (n/2, L, 128)."""
    if pair:
        return [pair_view(randn(g, n // 2, L, 2 * D)) for _ in range(3)]
    return [randn(g, n // 2, 2, L, D) for _ in range(3)]


def rows(g: torch.Generator, batch: int = 8, reps: int = 30, device: str = "cuda") -> List[Dict]:
    n = n_heads(batch)
    ops = {pair: operands(g, n, pair) for pair in (False, True)}
    return [stage_row(f"probe_dma_floor.{name}", f"{SCRIPT}:{line}", *ops[pair], stage, reps,
                      device, pair=pair, wpc=wpc, library=lib)
            for name, stage, pair, wpc, lib, line in SWEEP]


def main(argv=None) -> List[Dict]:
    return run_cli(sys.modules[__name__], argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
