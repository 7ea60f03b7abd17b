"""Device milliseconds of the port's hand-written kernels K1-K5 (by kernel
name, ``harness.trace.HAND_WRITTEN``) in one sequence or step; nothing
when none of them ran."""


def read(ctx):
    t = ctx.layer.get("trace")
    if t is None or not t["hand_written_by_kernel_s"]:
        return None
    return t["hand_written_s"] * 1e3 / t["per"]
