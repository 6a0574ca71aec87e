"""The share of the traced serving window in which no operation ran on the
device (the union of the trace's device intervals)."""


def read(ctx):
    if ctx["unit"] not in ("request", "prompt") or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
