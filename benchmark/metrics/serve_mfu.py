"""The served requests' model FLOPs (the eval forward of each request,
``work.py``) over the traced window, as a share of the bf16 dense peak."""

from benchmark.work import PEAK_BF16


def read(ctx):
    if ctx["unit"] not in ("request", "prompt") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["flops"] / ctx["window_s"] / PEAK_BF16
