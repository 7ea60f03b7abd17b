"""Device-timeline milliseconds (the operations, and the idle while the device
waited for the next launch) a unit (sequence, step or frame) owned by the
port's ``tln.train.backward`` and ``tln.backward.*`` spans
(``harness/program_spans.py``)."""

from harness.program_spans import layer_ms


def read(ctx):
    return layer_ms(ctx, "backward", "device")
