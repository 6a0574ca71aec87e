"""Device-idle ms a request or prompt in the serving forward's span
``sam3.forward`` (``_forward``, ``backbone_image``, ``ground``)."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("request", "prompt"), ("sam3.forward",))
