"""Device-idle ms an update in the self time of the training forward's span
``sam3.forward`` (``model(mb)``; its nested ``sam3.match`` is not counted
here)."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("train",), ("sam3.forward",))
