"""Device-idle ms a request or prompt in ``sam3.preprocess``: the image to an
array, its upload, resize and normalization; tokenizing and uploading the
prompts; the geometry prompts."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("request", "prompt"), ("sam3.preprocess",))
