"""Training-step throughput of the port at SemanticKITTI scale: forward,
BPTT backward and AdamW update for a full sequence (the counterpart of the
repository's ``scripts/train_bench.py``, with its flags, defaults and
keys; ``--frames`` for longer windows).

    python -m temporal_latticenet_tpu_torch.train_bench [--remat none] [--cpu]

Runs on CUDA unless ``--cpu`` is given; without a card it raises.  The
pointnet max takes kernel K4, or K5 and K4 under ``TLN_MAXSCAN_PACKED=1``.

Timing protocol: the first step (first use of every kernel, cuBLAS and the
caching allocator) is ``compile_seconds``; then ``--iters`` synced steps,
each followed by a fetch of its loss, whose minimum is
``seconds_per_step_synced``; then the headline, ``--iters`` steps queued
with real AdamW updates and one fetch of the last loss at the end
(``scripts/train_bench.py``'s jitted ``fori_loop`` of steps; its extra
warm call of that loop has no counterpart here).  ``value`` is
``frames * --points / seconds_per_step``, as in the JAX script, even where
the lidar generator's masks hold another count of points.

Prints a JSON line of details (the pointnet max's route, the launches of
K1-K5 in one step, peak device memory, the card's name and power limit
from ``nvidia-smi``, the torch and CUDA versions), then the result line
last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .bench import capacities
from .config import ModelConfig, RuntimeConfig
from .data.lidar_like import lidar_sequence
from .data.synthetic import synthetic_sequence
from .device import describe, resolve_device, synchronize
from .ops import _cuda
from .ops.segment import packed_route
from .train import engine

MAX_POINTS = 131072     # scripts/train_bench.py:67


def run(rt: RuntimeConfig, cfg: ModelConfig, *, points: int = 120_000,
        generator: str = "lidar", iters: int = 5, device=None) -> dict:
    """Time the training step at ``rt`` and ``cfg`` (see the module
    docstring); prints the details line and the result line.  Returns the
    result."""
    device = resolve_device(device)
    build = _cuda.build() if device.type == "cuda" else None
    frames = cfg.frames_per_seq
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3, seed=0,
                                             device=device)
    train_step, _ = engine.make_train_step(model, cfg, rt)

    rng = np.random.default_rng(0)
    if generator == "lidar":
        p, v, lab, m = lidar_sequence(rng, frames, rt.max_points)
    else:
        p, v, lab, m = synthetic_sequence(rng, frames, points, rt.max_points)
    batch = engine.SeqBatch(*(torch.as_tensor(a, device=device)[None]
                              for a in (p, v, lab, m)))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    state, logp, metrics = train_step(state, batch, 1.0)
    loss = float(metrics["loss"])
    compile_s = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    print(f"compile+first step: {compile_s:.1f}s loss={loss:.4f}", flush=True)

    ts = []
    for _ in range(iters):
        synchronize(device)
        t0 = time.perf_counter()
        state, logp, metrics = train_step(state, batch, 1.0)
        float(metrics["loss"])
        ts.append(time.perf_counter() - t0)
    dt_synced = min(ts)

    # headline: the steps queued one after another (each carries the last
    # one's weights), one fetch of the last loss at the end
    n_loop = iters
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_loop):
        state, logp, metrics = train_step(state, batch, 1.0)
    float(metrics["loss"])
    dt = (time.perf_counter() - t0) / n_loop

    details = {
        "pointnet_max_route": ("K5 + K4 (TLN_MAXSCAN_PACKED=1)"
                               if packed_route() else "K4"),
        "launches_per_step": launches,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        "build_seconds": build and build["seconds"],
        "points_per_frame": int(m.sum(1).mean()),
        "seconds_per_step_synced_all": ts,
        **describe(device),
    }
    print(json.dumps({"details": details}), flush=True)
    result = {
        "metric": f"semantickitti_{frames}frame_train_step",
        "value": round(frames * points / dt, 1),
        "unit": "points/sec/chip",
        "seconds_per_step": dt,
        "seconds_per_step_synced": dt_synced,
        "timing_protocol": "iters steps queued back to back (real AdamW "
                           "updates), one loss fetch at the end; synced = "
                           "one loss fetch after each step",
        "compile_seconds": compile_s,
        "remat": rt.remat_mode,
        "trim_capacity": rt.trim_capacity_level0,
        "final_capacity": rt.final_capacity_level0,
        "vertex_overflow": bool(metrics.get("vertex_overflow", False)),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Training-step throughput of the port at "
        "SemanticKITTI scale")
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--capacity", type=int, default=0,
                    help="level-0 capacity; 0 = per-generator default")
    ap.add_argument("--generator", choices=("lidar", "synthetic"),
                    default="lidar")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--frames", type=int, default=4,
                    help="sequence length (frames_per_seq); longer windows "
                    "need --capacity/--trim-capacity/--final-capacity sized "
                    "to the deeper union")
    ap.add_argument("--remat", choices=("full", "selective", "none"),
                    default="selective",
                    help="BPTT remat mode (engine.sequence_forward)")
    ap.add_argument("--trim-capacity", type=int, default=-1,
                    help="trimmed-frame level-0 capacity (frames 0..T-2 of "
                    "the BPTT run on row prefixes, forward AND backward; "
                    "RuntimeConfig.trim_capacity_level0). -1 = "
                    "per-generator default (lidar: 36864, as the bench); "
                    "0 disables")
    ap.add_argument("--final-capacity", type=int, default=-1,
                    help="FINAL-frame level-0 capacity "
                    "(RuntimeConfig.final_capacity_level0). -1 = "
                    "per-generator default (lidar: 40960, as the bench); "
                    "0 disables")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)

    capacity, trim, ftrim = capacities(args.generator, args.capacity,
                                       args.trim_capacity,
                                       args.final_capacity)
    rt = RuntimeConfig(max_points=MAX_POINTS, capacity_level0=capacity,
                       capacity_decay=0.5, min_capacity=8192, sigma=0.6,
                       remat_mode=args.remat, trim_capacity_level0=trim,
                       final_capacity_level0=ftrim)
    cfg = ModelConfig(nr_classes=26,
                      rnn_modules=("gru", "gru", "aflow", "gru"),
                      frames_per_seq=args.frames)
    return run(rt, cfg, points=args.points, generator=args.generator,
               iters=args.iters, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
