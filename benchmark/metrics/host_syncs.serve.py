"""The program's blocking transfers a request or prompt (its counter
``host_syncs``)."""

from benchmark.program import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, ("request", "prompt"), "host_syncs")
