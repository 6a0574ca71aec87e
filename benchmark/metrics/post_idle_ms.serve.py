"""Device-idle ms a request or prompt in ``sam3.post``: the read-back of the
scores and boxes, the thresholds, boxes to pixels, selecting, resizing and
copying the masks to the host."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("request", "prompt"), ("sam3.post",))
