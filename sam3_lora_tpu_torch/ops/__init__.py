"""The port's operations and hand-written kernels.

``routes()`` is the one list of the module-level flags that pick a kernel at
call time (``chip_smoke.py`` and the tests set them): whoever keeps what a
forward launched (the serving graphs, ``graphs.py``) keys on it. A new
routing flag is added here.
"""


def routes() -> tuple:
    """The routing flags' values, as a tuple."""
    from . import gemm_int8, window_attention, window_qkv

    return (gemm_int8.GEMM_LORA_FUSED, gemm_int8.GEMM_BWD_KERNEL, window_qkv.QKV_NATIVE,
            window_attention._PACKED, window_attention.FUSE_ROPE,
            window_attention._FORCE_INTERPRET)
