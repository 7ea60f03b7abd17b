"""Trace and sync readings of a run with ``--trace 1``: a copy of the port's
``utils/profiling.window`` (a ``torch.profiler`` session that starts
recording after a discarded warm-up step, since a session loses its first
device events) and ``host_syncs`` (torch's sync debug mode), and the
reduction of a trace to what the per-layer metrics read.
"""

from __future__ import annotations

import bisect
import contextlib
import time
import warnings

import torch

WARM_UP_LAUNCHES = 1024
WINDOW_SPAN = "bench.traced"

# the port's hand-written kernels by device kernel name (K1-K5)
HAND_WRITTEN = (("simplex_kernel", "K1"), ("seg_max_window_kernel", "K5"),
                ("seg_sum_tails_", "K3"), ("seg_scan_lookback", "K2"),
                ("seg_max_lookback", "K4"))


def hand_written(name: str):
    for part, k in HAND_WRITTEN:
        if part in name:
            return k
    return None


@contextlib.contextmanager
def window():
    """A ``torch.profiler`` session of CPU and CUDA activity whose recording
    starts after a discarded step of ``WARM_UP_LAUNCHES`` one-element
    operations; yields the profile."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_UP_LAUNCHES - 1):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        try:
            yield prof
        finally:
            torch.cuda.synchronize()


@contextlib.contextmanager
def host_syncs():
    """Counts the calls inside that made the host wait for the card (the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``); yields a
    one-entry list holding the count."""
    count = [0]

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            count[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """What the per-layer metrics read from a finished profile whose traced
    work ran inside a ``WINDOW_SPAN`` span: the device operations (kernels,
    copies, fills) inside it, their busy and the window's seconds, device
    seconds by kernel name and of K1-K5, and the idle gaps by the host
    span that was open."""
    events = prof.events()
    spans = [e for e in events if e.name == WINDOW_SPAN
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    notes = {e.name for e in events
             if getattr(e, "is_user_annotation", False)
             and e.device_type == torch.autograd.DeviceType.CPU}
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if (getattr(e, "is_user_annotation", False) or e.name in notes
                    or e.name.startswith("ProfilerStep")):
                continue
            if s >= w0 and t <= w1 + 5e5:
                dev.append(e)
        elif s < w1 and t > w0 and e.name != WINDOW_SPAN:
            host.append(e)
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    end = max(w1, max(e.time_range.end for e in dev))
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    by_name, hand = {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        name = e.name.replace("void ", "")[:120]
        by_name[name] = by_name.get(name, 0.0) + us
        k = hand_written(e.name)
        if k:
            hand[k] = hand.get(k, 0.0) + us
    # idle gaps: attributed to the innermost user span and host operation
    # open at the gap's start
    gaps, prev = {}, w0
    anno = sorted((e for e in host if e.name in notes),
                  key=lambda e: e.time_range.start)
    ops = sorted((e for e in host if e.name not in notes
                  and not e.name.startswith("cuda")),
                 key=lambda e: e.time_range.start)

    starts = ([e.time_range.start for e in anno],
              [e.time_range.start for e in ops])

    def innermost(lst, first, at):
        """The open event that started last before ``at``."""
        for i in range(bisect.bisect_right(first, at) - 1, -1, -1):
            if lst[i].time_range.end >= at:
                return lst[i].name
        return "none"

    for s, e in busy + [[end, end]]:
        if s > prev:
            key = (f"{innermost(anno, starts[0], prev)} / "
                   f"{innermost(ops, starts[1], prev)}")
            gaps[key] = gaps.get(key, 0.0) + (s - prev)
        prev = max(prev, e)
    busy_us = sum(e - s for s, e in busy)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": len(dev), "busy_s": busy_us / 1e6,
            "window_s": (end - w0) / 1e6,
            "hand_written_s": sum(hand.values()) / 1e6,
            "hand_written_by_kernel_s": {k: v / 1e6 for k, v in hand.items()},
            "top_device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


def traced(unit, n: int):
    """Run ``unit`` ``n`` times under :func:`window` inside the window span;
    returns the reduction and the units' frames."""
    from torch.profiler import record_function

    frames = 0
    t0 = time.perf_counter()
    with window() as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(n):
                frames += unit()
            torch.cuda.synchronize()
    out = reduce(prof)
    out["host_s"] = time.perf_counter() - t0
    out["frames"] = frames
    return out
