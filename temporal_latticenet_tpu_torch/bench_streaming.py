"""Online (streaming) per-frame inference latency of the port: the serving
path (the counterpart of the repository's ``scripts/bench_streaming.py``,
with its flags, defaults and keys).

    python -m temporal_latticenet_tpu_torch.bench_streaming \\
        [--streams 4] [--cpu]

The offline bench (``bench``) runs a whole 4-frame sequence at once over
the sequence lattice; a deployed system sees one scan at a time and
carries the vertex tables and hidden states from frame to frame.  This
measures that path's latency a frame: trimmed frames (state update only)
and the final frame (full log-probabilities), each timed with a host fetch
of a value that depends on its result.  Then the incremental path
(``max_new`` 8192), and with ``--streams N > 1`` N streams stepped
together: over the ranks of a ``parallel.mesh`` when the process runs
under ``torchrun`` with a world size above 1 that divides N (one card a
rank; ``gloo`` with ``--cpu``), else batched on the one card.  Runs on
CUDA unless ``--cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import ModelConfig, RuntimeConfig
from .data.lidar_like import lidar_sequence
from .device import resolve_device
from .models.lnn_seq import LNNSeq
from .ops import _cuda
from .parallel import mesh as pmesh
from .train.engine import (make_streaming_inference,
                           make_streaming_inference_batched,
                           make_streaming_inference_incremental)

MAX_POINTS = 131072     # scripts/bench_streaming.py:42
MAX_NEW = 8192          # the incremental path's growth bound a frame


def _ms(xs) -> float:
    return round(float(np.median(xs) * 1e3), 1)


def run(rt: RuntimeConfig, cfg: ModelConfig, *, iters: int = 5,
        streams: int = 1, device=None) -> dict:
    """Time the streaming paths at ``rt`` and ``cfg`` (see the module
    docstring); prints the result line (on rank 0).  Returns the result."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    use_mesh = streams > 1 and world > 1 and streams % world == 0
    device = resolve_device(device)
    mesh = None
    if use_mesh:
        mesh = pmesh.make_mesh(device=device,
                               backend="gloo" if device.type == "cpu"
                               else None)
        device = mesh.device
    try:
        if device.type == "cuda":
            _cuda.build()
        return _measure(rt, cfg, iters, streams, device, mesh)
    finally:
        if mesh is not None:
            pmesh.close(mesh)


def _measure(rt, cfg, iters, streams, device, mesh) -> dict:
    model = LNNSeq(cfg, rt, device=device, seed=0)
    model.eval()
    if mesh is not None:
        pmesh.replicate(mesh, model)
    rng = np.random.default_rng(0)
    p, v, _, m = lidar_sequence(rng, 4, rt.max_points)
    P, V, M = (torch.as_tensor(a, device=device) for a in (p, v, m))
    pts = int(m.sum(1).mean())

    new_state_fn, step_fn, final_fn = make_streaming_inference(model, cfg, rt)

    def run_seq():
        s = new_state_fn()
        for t in range(3):
            s = step_fn(P[t], V[t], M[t], s)
        logp, sv, s, aux = final_fn(P[3], V[3], M[3], s)
        return float(logp.sum())

    t0 = time.perf_counter()
    run_seq()
    compile_s = time.perf_counter() - t0
    run_seq()

    # per-frame latencies, each frame ended by a host fetch through its
    # result
    trim_ts, final_ts = [], []
    for _ in range(iters):
        s = new_state_fn()
        float(s.h[0].sum())
        for t in range(3):
            t0 = time.perf_counter()
            s = step_fn(P[t], V[t], M[t], s)
            float(s.h[0].sum())
            trim_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        logp, sv, s, aux = final_fn(P[3], V[3], M[3], s)
        float(logp.sum())
        final_ts.append(time.perf_counter() - t0)

    # ---- incremental serving path --------------------------------------
    new_fn, istep_full, istep, ifinal = make_streaming_inference_incremental(
        model, cfg, rt, max_new=MAX_NEW)

    def run_inc():
        s, fs = new_fn()
        s, fs = istep_full(P[0], V[0], M[0], s, fs)
        for t in range(1, 3):
            s, fs = istep(P[t], V[t], M[t], s, fs)
        logp, sv, s, fs, aux = ifinal(P[3], V[3], M[3], s, fs)
        return float(logp.sum())

    t0 = time.perf_counter()
    run_inc()
    inc_compile_s = time.perf_counter() - t0
    run_inc()

    itrim, ifin = [], []
    for _ in range(iters):
        s, fs = new_fn()
        float(s.h[0].sum())
        s, fs = istep_full(P[0], V[0], M[0], s, fs)
        float(s.h[0].sum())
        for t in range(1, 3):
            t0 = time.perf_counter()
            s, fs = istep(P[t], V[t], M[t], s, fs)
            float(s.h[0].sum())
            itrim.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        logp, sv, s, fs, aux = ifinal(P[3], V[3], M[3], s, fs)
        float(logp.sum())
        ifin.append(time.perf_counter() - t0)

    # ---- concurrent serving streams (--streams N) ----------------------
    out_streams = {}
    if streams > 1:
        new_b, step_b, final_b = make_streaming_inference_batched(
            model, cfg, rt, mesh=mesh)
        B = streams
        PB, VB, MB = (a[:, None].expand((4, B) + tuple(a.shape[1:]))
                      for a in (P, V, M))

        def run_b():
            st = new_b(B)
            for t in range(3):
                st = step_b(PB[t], VB[t], MB[t], st)
            logp, sv, st, aux = final_b(PB[3], VB[3], MB[3], st)
            return float(logp.sum())

        t0 = time.perf_counter()
        run_b()
        b_compile = time.perf_counter() - t0
        run_b()
        bt, bf = [], []
        for _ in range(iters):
            st = new_b(B)
            float(st[0].h[0].sum())
            for t in range(3):
                t0 = time.perf_counter()
                st = step_b(PB[t], VB[t], MB[t], st)
                float(sum(s.h[0].sum() for s in st))
                bt.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            logp, _, st, _ = final_b(PB[3], VB[3], MB[3], st)
            float(logp.sum())
            bf.append(time.perf_counter() - t0)
        out_streams = {
            "streams": B,
            "mesh_devices": 1 if mesh is None else mesh.world_size,
            "streams_trimmed_frame_ms": _ms(bt),
            "streams_final_frame_ms": _ms(bf),
            "streams_compile_seconds": round(b_compile, 1),
        }

    out = {
        "metric": "streaming_per_frame_latency",
        **out_streams,
        "trimmed_frame_ms": _ms(trim_ts),
        "final_frame_ms": _ms(final_ts),
        "incremental_trimmed_frame_ms": _ms(itrim),
        "incremental_final_frame_ms": _ms(ifin),
        "points_per_frame": pts,
        "compile_seconds": round(compile_s, 1),
        "incremental_compile_seconds": round(inc_compile_s, 1),
        "note": "each frame's time ends with one host fetch of a value "
                "computed from its result, which waits for the card",
    }
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Streaming per-frame inference latency of the port")
    ap.add_argument("--capacity", type=int, default=49152)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent serving streams (over the ranks under "
                    "torchrun when their count divides it, else batched on "
                    "one card)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card)")
    args = ap.parse_args(argv)
    rt = RuntimeConfig(max_points=MAX_POINTS, capacity_level0=args.capacity,
                       capacity_decay=0.5, min_capacity=8192, sigma=0.6)
    cfg = ModelConfig(nr_classes=26,
                      rnn_modules=("gru", "gru", "aflow", "gru"),
                      frames_per_seq=4)
    return run(rt, cfg, iters=args.iters, streams=args.streams,
               device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
