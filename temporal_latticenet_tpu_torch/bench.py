"""Benchmark of the port: SemanticKITTI-scale 4-frame sequence inference
throughput on one card (the counterpart of the repository's ``bench.py``,
with its flags, defaults, metric and keys).

    python -m temporal_latticenet_tpu_torch.bench [--details] [--cpu] ...

Runs on CUDA unless ``--cpu`` is given; without a card it raises.  Prints
ONE JSON line last:
  {"metric": "semantickitti_4frame_seq_inference", "value": N,
   "unit": "points/sec/chip", "vs_baseline": N}

Metric: the real points (the masked returns, ``points_per_frame`` in the
details) across the frames of a sequence over the wall seconds a sequence,
flagship gru-gru-aflow-gru, 26 classes, bf16, sigma 0.6.  The padded row
count (``--max-points``) drives the work, so runs compare at a fixed
``points_per_frame``.  ``vs_baseline`` is the ratio to
``REFERENCE_A100_POINTS_PER_SEC_ESTIMATE``, ``bench.py``'s documented
estimate of the reference's CUDA pipeline on an A100 (about 50 ms a frame
of about 120k points: 4 x 120k / 0.2 s = 2.4M points/s).  It is an
engineering estimate, not a measured baseline.

Timing protocol:
  * the CUDA kernels are built (``ops/_cuda.build``) before any timing;
  * the first forward (first use of every kernel, cuBLAS and the caching
    allocator) is ``compile_seconds``; its launches of K1-K5 and the
    occupancy and trim honesty outputs are recorded, with a warning on
    stderr when a table saturates or a trim overflows;
  * one warm synchronised sequence: the fallback result;
  * 3 repetitions, each queueing ``--iters`` forwards back to back with
    each ``logp.sum()`` added into one device accumulator and one host
    wait at the end: one wait for ``--iters`` sequences, what
    ``bench.py``'s jitted ``fori_loop`` amortises.  The headline is the
    median over the repetitions; the details hold each, their minimum and
    maximum and the single sequence's time;
  * on a card, the host syncs inside one forward (``torch.cuda``'s sync
    debug mode): a sync there caps how far the host can queue ahead.
``--details`` adds the synced protocol (one host wait a sequence) and the
pipelined one (queue the sequences, then one fetch of their sums).

Left out of ``bench.py``: the tiny-geometry init, which only spares a
second XLA compile (the weights here come from the port's seeded init,
``torch.Generator`` seed 0, at the bench geometry); the ``i * 1e-12``
position offset that keeps XLA from hoisting the loop body (torch hoists
nothing); the ``baseline_bounds`` decoration, which executes
``scripts/roofline.py``, outside the port.

Budget (``bench.py``'s): a watchdog thread fires at
``TLN_BENCH_BUDGET_S`` seconds (default 480) after ``main`` starts, as
does SIGTERM or SIGINT: it prints the best measurement so far and exits 0,
or exits 3 when nothing was measured.  When the budget nearly ran out
after the first forwards, the repetitions take fewer sequences.

The details (``bench.py``'s fields, the card's name and power limit from
``nvidia-smi``, the torch and CUDA versions, peak device memory, launches
and host syncs of one forward) go to ``bench_details_torch.json`` in the
working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from .config import ModelConfig, RuntimeConfig
from .data.lidar_like import lidar_sequence
from .data.synthetic import synthetic_sequence
from .device import describe, resolve_device, synchronize
from .models.lnn_seq import LNNSeq
from .ops import _cuda
from .train.engine import make_sequence_forward
from .utils.profiling import host_syncs

REFERENCE_A100_POINTS_PER_SEC_ESTIMATE = 2.4e6
DETAILS_FILE = "bench_details_torch.json"
METRIC = "semantickitti_4frame_seq_inference"
REPS = 3

FLAGSHIP = ModelConfig(
    nr_classes=26,
    rnn_modules=("gru", "gru", "aflow", "gru"),
    frames_per_seq=4,
)


def budget_s() -> float:
    return float(os.environ.get("TLN_BENCH_BUDGET_S", "480"))


class Best:
    """The best measurement so far, shared with the watchdog and the signal
    handler, and the budget's clock."""

    def __init__(self, budget: float):
        self.budget = budget
        self.t0 = time.perf_counter()
        self.result = self.details = None
        self.emitted = False
        # RLock: a SIGTERM landing while the main thread is inside emit()
        # runs the handler on that same thread
        self.lock = threading.RLock()

    def remaining(self) -> float:
        return self.budget - (time.perf_counter() - self.t0)

    def write_details(self) -> None:
        if self.details is None:
            return
        try:
            with open(DETAILS_FILE, "w") as f:
                json.dump(self.details, f, indent=2)
        except OSError:
            pass

    def emit(self) -> bool:
        """Print the headline JSON exactly once; returns True if printed."""
        with self.lock:
            if self.emitted:
                return True
            if self.result is None:
                return False
            print(json.dumps(self.result), flush=True)
            self.emitted = True
            self.write_details()
            return True

    def exit_now(self, *_):
        """The watchdog's and the signal handler's end: the best result so
        far and rc 0, or rc 3 when nothing was measured."""
        emitted = self.emit()
        sys.stdout.flush()
        os._exit(0 if emitted else 3)


def capacities(generator: str, capacity: int, trim_capacity: int,
               final_capacity: int):
    """``bench.py``'s per-generator defaults (lidar 49152 / 36864 / 40960,
    synthetic 98304 / 0 / 0) for the flags left at 0 / -1 / -1."""
    lidar = generator == "lidar"
    cap = capacity or (49152 if lidar else 98304)
    trim = trim_capacity if trim_capacity >= 0 else (36864 if lidar else 0)
    ftrim = final_capacity if final_capacity >= 0 else (40960 if lidar
                                                        else 0)
    return cap, trim, ftrim


def bench_data(generator: str, frames: int, points: int, max_points: int):
    """``bench.py``'s sequence: ``default_rng(0)``; lidar with
    ``max(256, points // 64)`` azimuths of 64 beams, synthetic with
    ``min(points, max_points)`` points.  Returns (positions, values,
    mask) numpy arrays."""
    rng = np.random.default_rng(0)
    points = points or max_points
    if generator == "lidar":
        p, v, _, m = lidar_sequence(rng, frames=frames, max_points=max_points,
                                    n_az=max(256, points // 64))
    else:
        p, v, _, m = synthetic_sequence(rng, frames=frames,
                                        n_points=min(points, max_points),
                                        max_points=max_points)
    return p, v, m


def run(rt: RuntimeConfig, *, generator: str = "lidar", frames: int = 4,
        iters: int = 8, points: int = 0, details: bool = False,
        device=None, best: Best | None = None):
    """Measure the forward at ``rt`` (see the module docstring); prints the
    headline line and writes ``DETAILS_FILE``.  Returns ``(result,
    details)``.  ``best`` holds the budget (default: ``budget_s()`` from
    now) and the result so far."""
    best = best or Best(budget_s())
    device = resolve_device(device)
    build = _cuda.build() if device.type == "cuda" else None
    info = describe(device)
    cfg = FLAGSHIP
    model = LNNSeq(cfg, rt, device=device, seed=0)
    model.eval()
    seq_fwd = make_sequence_forward(model, cfg, rt)
    p, v, m = bench_data(generator, frames, points, rt.max_points)
    positions, values, mask = (torch.as_tensor(a, device=device)
                               for a in (p, v, m))
    points_per_frame = int(m.sum(1).mean())
    caps = rt.capacities(cfg.nr_downsamples)

    def fwd():
        return seq_fwd(positions, values, mask)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    logp, _, aux = fwd()
    float(logp.sum())
    compile_s = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    occupancy = [int(x) for x in aux["occupancy"].cpu()]
    trim_overflowed = bool(aux["trim_overflow"])
    vertex_overflow = bool(aux["vertex_overflow"])

    # a saturated table silently drops vertices, making the measured
    # workload smaller than the input deserves
    saturated = [o >= c for o, c in zip(occupancy, caps)]
    if any(saturated):
        print(f"WARNING: vertex table saturated (occupancy {occupancy} vs "
              f"capacities {list(caps)}); the headline number is measured "
              f"with dropped vertices -- raise --capacity", file=sys.stderr)
    if trim_overflowed:
        print(f"WARNING: trim capacity overflow (trim "
              f"{rt.trim_capacities(2)} < frame-{frames - 2} occupancy "
              f"or final {rt.final_capacities(2)} < final-union occupancy); "
              f"frames dropped vertex compute -- raise --trim-capacity / "
              f"--final-capacity", file=sys.stderr)

    syncs = None
    if device.type == "cuda":
        synchronize(device)
        with host_syncs() as syncs:
            fwd()

    def pack(dt, protocol, extra=None):
        pts_per_sec = frames * points_per_frame / dt
        result = {
            "metric": METRIC,
            "value": round(pts_per_sec, 1),
            "unit": "points/sec/chip",
            "vs_baseline": round(
                pts_per_sec / REFERENCE_A100_POINTS_PER_SEC_ESTIMATE, 3),
        }
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        det = {**result, "seconds_per_sequence": dt,
               "timing_protocol": protocol,
               "compile_seconds": compile_s,
               "build_seconds": build and build["seconds"],
               "points_per_frame": points_per_frame,
               "frames": frames,
               "generator": generator,
               "capacities": list(caps),
               "trim_capacities": (list(rt.trim_capacities(2))
                                   if rt.trim_capacity_level0 else None),
               "final_capacities": (list(rt.final_capacities(2))
                                    if rt.final_capacity_level0 else None),
               "occupancy_final_union": occupancy,
               "saturated": any(saturated),
               "trim_overflowed": trim_overflowed,
               "vertex_overflow": vertex_overflow,
               "batched_pointnet": rt.batched_pointnet,
               **info,
               "peak_mem_bytes": peak,
               "launches_per_forward": launches,
               "host_syncs_per_forward": (None if syncs is None
                                          else sum(syncs.values())),
               "host_syncs_where": syncs,
               **(extra or {})}
        return result, det

    # warm single-sequence fallback, replaced by the repetitions below
    # unless the watchdog fires first
    synchronize(device)
    t0 = time.perf_counter()
    float(fwd()[0].sum())
    dt_single = time.perf_counter() - t0
    best.result, best.details = pack(
        dt_single, "single warm sequence, one host wait (budget fallback: "
        "the repetitions did not finish in time)")

    # budget guard: fewer sequences a repetition when the rest would not
    # fit, with 30 s left for the teardown
    n_loop = iters
    if best.remaining() < REPS * n_loop * dt_single + 30.0:
        n_loop = max(1, int((best.remaining() - 30.0)
                            / (REPS * max(dt_single, 1e-3))))
        print(f"WARNING: budget nearly spent after the first forwards "
              f"({best.remaining():.0f} s left); shrinking the repetitions "
              f"to {n_loop} sequences", file=sys.stderr)

    rep_dts = []
    for rep in range(REPS):
        synchronize(device)
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n_loop):
            acc += fwd()[0].sum()
        float(acc)
        rep_dts.append((time.perf_counter() - t0) / n_loop)
        dt = float(np.median(rep_dts))
        best.result, best.details = pack(
            dt, "iters forwards queued back to back, their logp sums added "
            "on the device, one host wait a repetition; median of "
            "repetitions",
            {"iters": n_loop, "reps": rep + 1,
             "seconds_per_sequence_reps": rep_dts,
             "seconds_per_sequence_min": min(rep_dts),
             "seconds_per_sequence_max": max(rep_dts),
             "seconds_per_sequence_single": dt_single})
        if best.remaining() < n_loop * dt + 15.0:
            break
    best.emit()   # the headline now; what follows is optional

    det = best.details
    if details and best.remaining() > 60.0:
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n_loop):
            float(fwd()[0].sum())
        det["seconds_per_sequence_synced"] = (
            (time.perf_counter() - t0) / n_loop)
        synchronize(device)
        t0 = time.perf_counter()
        sums = [fwd()[0].sum() for _ in range(n_loop)]
        float(torch.stack(sums).sum())
        det["seconds_per_sequence_pipelined"] = (
            (time.perf_counter() - t0) / n_loop)
    best.write_details()
    return best.result, det


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="SemanticKITTI-scale 4-frame sequence inference "
        "throughput of the port on one card")
    ap.add_argument("--points", type=int, default=0,
                    help="target points per scan (lidar: ray count); "
                    "0 = fill max-points (the static row count that "
                    "actually drives the work)")
    ap.add_argument("--max-points", type=int, default=131_072)
    ap.add_argument("--capacity", type=int, default=0,
                    help="level-0 capacity; 0 = per-generator default")
    ap.add_argument("--generator", choices=("lidar", "synthetic"),
                    default="lidar")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--details", action="store_true",
                    help="also time the synced / pipelined secondary "
                    "protocols")
    ap.add_argument("--batched-pointnet", dest="batched_pointnet",
                    action="store_true", default=True,
                    help="pointnet for all frames at once over the "
                    "union-sorted rows (segmented max, kernel K4; default)")
    ap.add_argument("--no-batched-pointnet", dest="batched_pointnet",
                    action="store_false",
                    help="A/B: per-frame pointnet scatters")
    ap.add_argument("--trim-capacity", type=int, default=-1,
                    help="trimmed-frame level-0 capacity (frames 0..T-2 run "
                    "on row prefixes; RuntimeConfig.trim_capacity_level0). "
                    "-1 = per-generator default (lidar: 36864); 0 disables")
    ap.add_argument("--final-capacity", type=int, default=-1,
                    help="FINAL-frame level-0 capacity (the last frame's "
                    "network runs on a row prefix; "
                    "RuntimeConfig.final_capacity_level0). -1 = "
                    "per-generator default (lidar: 40960); 0 disables")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    best = Best(budget_s())

    handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(sig, best.exit_now)
    except ValueError:      # not the main thread: no handler, the watchdog
        pass                # still runs
    # disarmed at the end: a still-armed timer would end a host process
    # that outlives the bench (a test that calls main)
    watchdog = threading.Timer(max(best.remaining(), 1.0), best.exit_now)
    watchdog.daemon = True
    watchdog.start()
    try:
        cap, trim, ftrim = capacities(args.generator, args.capacity,
                                      args.trim_capacity,
                                      args.final_capacity)
        rt = RuntimeConfig(max_points=args.max_points, capacity_level0=cap,
                           capacity_decay=0.5, min_capacity=8192, sigma=0.6,
                           batched_pointnet=args.batched_pointnet,
                           trim_capacity_level0=trim,
                           final_capacity_level0=ftrim)
        return run(rt, generator=args.generator, frames=args.frames,
                   iters=args.iters, points=args.points,
                   details=args.details, device="cpu" if args.cpu else None,
                   best=best)
    finally:
        watchdog.cancel()
        for sig, h in handlers.items():
            signal.signal(sig, h)


if __name__ == "__main__":
    main()
