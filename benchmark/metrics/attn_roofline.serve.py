"""The attention kernels' share of their roofline in serving: the least
time of the ViT's and the fusion encoder's self-attention forward that the
window's requests need (``work.attention_work`` from the
configuration's shapes), over the device time of the kernels that do it."""

from benchmark.trace import device_seconds

KERNELS = ("attention_fwd_kernel", "rope_kernel")


def read(ctx):
    t = device_seconds(ctx["device"], KERNELS)
    if ctx["unit"] not in ("request", "prompt") or t <= 0:
        return None
    return 100.0 * ctx["work"]["attn"][2] / t
