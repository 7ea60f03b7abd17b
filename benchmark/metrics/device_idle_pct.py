"""The share of the traced interval in which no operation ran on the
device, in percent."""


def read(ctx):
    t = ctx.layer.get("trace")
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
