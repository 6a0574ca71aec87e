"""The attention kernels' share of their roofline in training: the least
time of the ViT's and the fusion encoder's self-attention, forward and
backward, that the window's updates need (``work.attention_work`` from the
configuration's shapes), over the device time of the kernels that do it."""

from benchmark.trace import device_seconds

KERNELS = ("attention_fwd_kernel", "rope_kernel", "bwd_prep_kernel", "dkdv_kernel", "dq_kernel")


def read(ctx):
    t = device_seconds(ctx["device"], KERNELS)
    if ctx["unit"] != "train" or t <= 0:
        return None
    return 100.0 * ctx["work"]["attn"][2] / t
