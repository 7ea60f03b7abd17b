"""The model's matrix-product FLOPs of the measured window
(``metrics/flops.py`` over the occupied vertices and valid points of the
reference's lattice; a training step counts three forwards) over the
window's seconds, against one H100's dense bf16 peak (989 TFLOP/s), in
percent."""


def read(ctx):
    f, s = ctx.layer.get("window_flops"), ctx.layer.get("window_s")
    if not f or not s:
        return None
    return 100.0 * f / s / ctx.layer["peak_flops"]
