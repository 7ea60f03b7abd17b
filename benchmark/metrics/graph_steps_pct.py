"""The share of the traced training steps that the port served by replaying
CUDA graphs: its ``tln.engine.train_step`` spans with ``graph=1`` among
their ids, in percent of those spans.  None where the spans carry no
``graph`` id (a port without the step's graphs) or their number is not the
traced steps'."""

STEP = "tln.engine.train_step"


def read(ctx):
    trace = ctx.layer.get("trace")
    try:
        from temporal_latticenet_tpu_torch.utils import profiling
    except ImportError:
        return None
    log = getattr(profiling, "span_log", None)
    if trace is None or log is None:
        return None
    spans = [r for r in log() if r.name == STEP]
    if len(spans) != trace["per"] or \
            not all("graph" in r.ids for r in spans):
        return None
    return 100.0 * sum(r.ids["graph"] == 1 for r in spans) / len(spans)
