"""The program's blocking transfers an update (its counter ``host_syncs``:
reads to the host, and uploads that wait for the stream)."""

from benchmark.program import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, ("train",), "host_syncs")
