"""The int8 GEMM kernels' share of their roofline in training: the least
time of the frozen int8 products of the window's forwards (K4, K5;
``work.gemm_int8_work`` from the configuration's shapes, at the int8 peak),
over the device time of the kernels that compute them (the rows'
quantization, K5's first pass, the s8 mainloop)."""

from benchmark.trace import device_seconds

KERNELS = ("quant_rows_kernel", "lora_prep_kernel", "::S8Scaled>", "::S8ScaledLoRA>")


def read(ctx):
    t = device_seconds(ctx["device"], KERNELS)
    if ctx["unit"] != "train" or t <= 0:
        return None
    return 100.0 * ctx["work"]["int8"][2] / t
