"""MB read back to the host a request or prompt (the program's counter
``d2h_bytes`` over 1e6): the scores, the boxes, the answers' masks."""

from benchmark.program import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, ("request", "prompt"), "d2h_bytes", 1e-6)
