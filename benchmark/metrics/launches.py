"""Device operations (kernels, copies, fills) of one sequence, step or
frame, from the traced units."""


def read(ctx):
    t = ctx.layer.get("trace")
    return None if t is None else t["device_ops"] / t["per"]
