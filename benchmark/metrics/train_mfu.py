"""The training step's model FLOPs (``work.py``: forward, the frozen layers'
input gradients, the adapters' weight gradients, the attention backward; no
recomputation) over the traced window, as a share of the bf16 dense peak."""

from benchmark.work import PEAK_BF16


def read(ctx):
    if ctx["unit"] != "train" or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["flops"] / ctx["window_s"] / PEAK_BF16
