"""Device-idle ms an update while the program waits for its batch or pins
and enqueues it: the self time of the spans ``sam3.data.wait`` (the
consumer's ``q.get()`` on the loader's queue) and ``sam3.data.pin``
(``prefetch_to_device``)."""

from benchmark.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("train",), ("sam3.data.wait", "sam3.data.pin"))
