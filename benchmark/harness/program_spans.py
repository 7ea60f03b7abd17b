"""The port's own spans (``temporal_latticenet_tpu_torch.utils.profiling.span``)
of a ``--trace 1`` run, reduced to milliseconds a unit by layer, on the host
clock and on the device timeline.

The port records a span only inside a ``torch.profiler`` session, so its
log holds the traced units' spans alone: set-up, the window and the unit
whose syncs are counted run with no profiler.  One rule on each clock:
every instant inside an engine span (``tln.engine.*``, the outermost) goes
to the innermost span open at that instant, the one entered last, on any
thread.  The host clock is each span's ``perf_counter_ns`` pair; the device
timeline is each span's pair of CUDA events, read with ``elapsed_time``
against the log's first.  A span's device interval runs from the moment
the stream reached its entry to the moment it reached its exit, so a layer
owns its operations' time and the device's idle while it waited for the
layer's next launch.  Full remat's recompute runs inside
``tln.train.backward``, so it counts as lattice and model time.

Where the port keeps no span log (an older port), the log's engine spans
do not match the traced units, or the spans carry no device events (no
card), the readers get None.
"""

from __future__ import annotations

import heapq
import sys

CONTAINERS = ("tln.train.forward",)   # spans that hold layers, as engine


def _layer(name: str) -> str:
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def part_of(name: str) -> list:
    """The parts a span's owned time counts for: ``lattice``, ``model``,
    ``backward`` (``tln.train.backward`` and ``tln.backward.*``), and
    ``covered`` (every span but the engine's and its containers)."""
    layer = _layer(name)
    out = []
    if layer in ("lattice", "model"):
        out.append(layer)
    if layer == "backward" or name == "tln.train.backward":
        out.append("backward")
    if layer != "engine" and name not in CONTAINERS:
        out.append("covered")
    return out


def top_engine(records) -> list:
    """Whether each record is an engine span with no engine span above it."""
    out = []
    for r in records:
        top = r.layer == "engine"
        p = r.parent
        while top and p is not None:
            top = p.layer != "engine"
            p = p.parent
        out.append(top)
    return out


def owned(intervals, engine) -> dict:
    """``intervals``: (name, start, end) in the order the spans were
    entered; ``engine``: whether each is an outermost engine span.
    Returns {name: time owned}: each instant inside an engine span goes to
    the open span entered last."""
    edges = []
    for i, (_, s, e) in enumerate(intervals):
        edges.append((s, 1, i))
        edges.append((e, 0, i))
    edges.sort()
    out, heap, live, engines = {}, [], set(), 0
    prev = None
    for t, opening, i in edges:
        if prev is not None and t > prev and engines:
            while -heap[0] not in live:
                heapq.heappop(heap)
            name = intervals[-heap[0]][0]
            out[name] = out.get(name, 0.0) + (t - prev)
        prev = t
        if opening:
            live.add(i)
            heapq.heappush(heap, -i)
            engines += engine[i]
        else:
            live.discard(i)
            engines -= engine[i]
    return out


def clocks(records):
    """(host intervals in ms, device intervals in ms or None)."""
    host = [(r.name, r.t0 / 1e6, r.t1 / 1e6) for r in records]
    if any(r.ev0 is None or r.ev1 is None for r in records):
        return host, None
    first = records[0].ev0
    dev = [(r.name, first.elapsed_time(r.ev0), first.elapsed_time(r.ev1))
           for r in records]
    return host, dev


def reduce_log(records, units: float):
    """{"host": {name: ms a unit}, "device": {...} or None} of a log whose
    outermost engine spans number ``units``, or None."""
    records = [r for r in records if r.t1 is not None]
    engine = top_engine(records)
    if not records or sum(engine) != units:
        return None
    host, dev = clocks(records)
    out = {"host": owned(host, engine), "device": None}
    if dev is not None:
        out["device"] = owned(dev, engine)
    for clock in ("host", "device"):
        if out[clock] is not None:
            out[clock] = {k: v / units for k, v in out[clock].items()}
    return out


def total(by_name: dict, part: str) -> float:
    return sum(v for k, v in by_name.items() if part in part_of(k))


def spans_line(red: dict) -> str:
    host, dev = red["host"], red["device"] or {}
    names = sorted(host, key=lambda k: -host[k])
    cells = ", ".join(f"{k} {host[k]:.3f} / {dev.get(k, float('nan')):.3f}"
                      for k in names)

    def cover(by):
        whole = sum(by.values())
        return 100.0 * total(by, "covered") / whole if whole else 0.0

    return (f"spans: self ms a unit, host / device: {cells}; layer spans "
            f"cover {cover(host):.1f} % / "
            f"{cover(dev) if dev else float('nan'):.1f} % of the engine "
            f"spans")


def reduction(ctx):
    """The run's reduction, made once (and its ``spans:`` line printed on
    standard error), or None."""
    if "program_spans" not in ctx.layer:
        red = None
        trace = ctx.layer.get("trace")
        try:
            from temporal_latticenet_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        log = getattr(profiling, "span_log", None)
        if trace is not None and log is not None:
            red = reduce_log(list(log()), trace["per"])
        if red is not None:
            print(spans_line(red), file=sys.stderr)
        ctx.layer["program_spans"] = red
    return ctx.layer["program_spans"]


def layer_ms(ctx, part: str, clock: str):
    """Milliseconds a unit of ``part`` (``lattice``, ``model``,
    ``backward``) on ``clock`` (``host``, ``device``), or None."""
    red = reduction(ctx)
    if red is None or red[clock] is None:
        return None
    return total(red[clock], part)
