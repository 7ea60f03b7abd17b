"""Tracing and profiling (the PyTorch counterpart of the JAX package's
``utils/profiling.py``).

``span(name, **ids)`` marks one region of the port: every layer boundary
(engine entry points, the lattice, the model's stages, the training
step's phases and the custom backwards) opens one, named
``tln.<layer>.<part>``.  Outside a ``torch.profiler`` session and outside
``recording()`` a span is a shared no-op context (one flag read).  Inside
either it enters ``torch.profiler.record_function(name)`` (the ids, such
as the engine's unit number and the frame index, as its args), and
appends a ``SpanRecord`` to an in-memory log that ``span_log()`` returns:
the host interval (``time.perf_counter_ns``) and, where CUDA is in use,
a pair of timing events on the current stream, from which the device
interval follows.  ``recording()`` is the operator's use: the log of the
calls inside without a profiler, such as a 10 Hz stream's per-frame
split between lattice and model.  ``without_spans()`` turns spans off
inside a profiler session.

``trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity where a card is present) and writes it as a Chrome trace;
``host_syncs`` counts the calls that made the host wait for the card;
``enable_nan_debugging`` is ``torch.autograd.set_detect_anomaly``, the
reference's own debug aid (upstream train_ln.py:36).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import traceback
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

TRACE_FILE = "trace.json"
# the checkout that holds the package: host_syncs names lines inside it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# device operations of the discarded warm-up step of ``window``
WARM_UP_LAUNCHES = 1024


# records the span log keeps; past it the oldest are dropped
SPAN_LOG_SIZE = 65536


class SpanRecord:
    """One span, and the context that records it: ``name``, ``layer`` (the
    name's second dotted part), the thread it ran on (``tid``), the span
    open when it was entered (``parent``: on its own thread, else the last
    one entered on any thread, as for a backward on autograd's thread), its
    ``ids``, the host interval ``t0``/``t1`` (``perf_counter_ns``) and the
    timing events ``ev0``/``ev1`` (``torch.Event``) recorded on the current
    CUDA stream at entry and exit (None without CUDA)."""

    __slots__ = ("name", "layer", "tid", "parent", "ids", "t0", "t1", "ev0",
                 "ev1", "_fn")

    def __init__(self, name: str, ids: dict):
        parts = name.split(".")
        self.name, self.ids = name, ids
        self.layer = parts[1] if len(parts) > 1 else name
        self.tid = self.parent = self.t0 = self.t1 = None
        self.ev0 = self.ev1 = None

    def __enter__(self):
        args = ",".join(f"{k}={v}" for k, v in self.ids.items())
        self._fn = record_function(self.name, args or None)
        self._fn.__enter__()
        self.tid = tid = threading.get_ident()
        self.parent = next((r for r in reversed(_OPEN) if r.tid == tid),
                           _OPEN[-1] if _OPEN else None)
        _OPEN.append(self)
        _LOG.append(self)
        if torch.cuda.is_initialized():
            self.ev0 = _timing_event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = _timing_event()
        _OPEN.remove(self)
        self._fn.__exit__(*exc)
        self._fn = None


_LOG = collections.deque(maxlen=SPAN_LOG_SIZE)
_OPEN = []                  # records entered and not left, every thread
_OFF = contextlib.nullcontext()
_recording = False
_muted = False


def _timing_event():
    # torch.Event, not torch.cuda.Event: the garbage collector does not
    # track it, so a log of them sets off no extra collections
    ev = torch.Event(device="cuda", enable_timing=True)
    ev.record()
    return ev


def span(name: str, **ids):
    """The context of one region of the port (module docstring): a shared
    no-op unless a ``torch.profiler`` session is active or ``recording()``
    is on."""
    if not (_autograd_profiler._is_profiler_enabled or _recording) \
            or _muted:
        return _OFF
    return SpanRecord(name, ids)


def span_log() -> collections.deque:
    """The recorded spans (``SpanRecord``), in the order they were entered;
    at most the last ``SPAN_LOG_SIZE``."""
    return _LOG


@contextlib.contextmanager
def recording():
    """Clear the span log and record the spans of the calls inside, with
    no profiler; yields the log."""
    global _recording
    _LOG.clear()
    before, _recording = _recording, True
    try:
        yield _LOG
    finally:
        _recording = before


@contextlib.contextmanager
def without_spans():
    """Spans off inside, even under a profiler session."""
    global _muted
    before, _muted = _muted, True
    try:
        yield
    finally:
        _muted = before


@contextlib.contextmanager
def window(warm_up_launches: int = WARM_UP_LAUNCHES, settle_s: float = 0.0):
    """A ``torch.profiler`` session (CPU activity, and CUDA activity where a
    card is present) around the calls inside; yields the profile.

    A session loses the first device events that follow the start of its
    tracing, and the more, the older the process: one more each 10-16 s
    of a process's life on an NVIDIA H100 80GB HBM3 at 700 W, and now and
    then a few dozen (``scripts/torch_profiler_windows.py``).  The loss is
    counted in events, not in time: a pause of ``settle_s`` seconds
    between the start of the recording and the calls inside does not take
    it.  Where a card is present, recording therefore starts only after a
    discarded warm-up step (``schedule(warmup=1, active=1)``, whose
    ``ProfilerStep`` span the trace keeps) of ``warm_up_launches``
    one-element operations, which do.  A caller that needs every kernel
    still checks for them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()    # work queued before stays outside
    warm = cuda and (warm_up_launches > 0 or settle_s > 0)
    sched = schedule(wait=0, warmup=1, active=1) if warm else None
    with profile(activities=acts, schedule=sched) as prof:
        if warm:
            x = torch.zeros(1, device="cuda")
            for _ in range(warm_up_launches - 1):
                x.add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(settle_s)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the calls inside (``window``) and write
    ``log_dir/trace.json`` (viewable in Perfetto or ``chrome://tracing``);
    yields the ``torch.profiler`` profile, or None when ``log_dir`` is empty
    (no trace)."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    with window() as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print("profiler trace written to", path)


@contextlib.contextmanager
def host_syncs():
    """Counts the calls inside the block that made the host wait for the
    card (the warnings of ``torch.cuda``'s sync debug mode), by the
    innermost line of the repository that holds this package on the stack
    that made them (``"file:line"``, or ``"outside the repository"``);
    yields that dict, filled in as the block runs.  A sync inside a
    forward caps how far ahead of the card the host can queue."""
    where = {}

    def record(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()
                if f.filename.startswith(REPO) and f.filename != __file__]
        key = (f"{os.path.relpath(mine[-1].filename, REPO)}:"
               f"{mine[-1].lineno}" if mine else "outside the repository")
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield where
        finally:
            torch.cuda.set_sync_debug_mode(0)


def enable_nan_debugging(enable: bool = True):
    """Autograd's anomaly mode: a backward that produces NaN raises, with
    the traceback of the forward operation at fault."""
    torch.autograd.set_detect_anomaly(enable)
