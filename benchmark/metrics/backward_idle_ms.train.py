"""Device-idle ms an update in the backward (``sam3.backward``) and the update
(``sam3.update``: the gradients' all-reduce, the clip, AdamW)."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("train",), ("sam3.backward", "sam3.update"))
