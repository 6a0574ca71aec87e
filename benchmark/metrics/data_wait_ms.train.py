"""The mean host milliseconds a training step waits for its batch: the
benchmark's span around ``next()`` on the prefetch iterator."""


def read(ctx):
    waits = ctx.get("data_wait_s") or []
    if ctx["unit"] != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
