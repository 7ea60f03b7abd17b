"""Tracing and profiling (the PyTorch counterpart of the JAX package's
``utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity where a card is present) and writes it as a Chrome trace; the
model marks its phases with ``torch.profiler.record_function`` spans of the
JAX package's ``jax.named_scope`` names ("distribute", "pointnet").
``wall_timer`` and ``block`` time quick spans; ``enable_nan_debugging`` is
``torch.autograd.set_detect_anomaly``, the reference's own debug aid
(upstream train_ln.py:36).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


# device operations of the discarded warm-up step of ``window``
WARM_UP_LAUNCHES = 1024


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
def wall_timer(name: str, sink=print):
    """Host seconds of the calls inside, the card's queued work included
    (synchronised at both ends once CUDA is in use)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    sink(f"[{name}] {time.perf_counter() - t0:.4f}s")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree):
    """Wait until the work behind every tensor of a nested structure
    (dicts, lists, tuples) is done on its device; returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def enable_nan_debugging(enable: bool = True):
    """Autograd's anomaly mode: a backward that produces NaN raises, with
    the traceback of the forward operation at fault."""
    torch.autograd.set_detect_anomaly(enable)
