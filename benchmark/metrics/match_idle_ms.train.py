"""Device-idle ms an update in the matching (``sam3.match``: the Hungarian
cost's read-back, the solve on the host, the indices' upload, the top-k
one-to-many) and the losses (``sam3.loss``)."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("train",), ("sam3.match", "sam3.loss"))
