#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``temporal_latticenet_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero without the final line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels K1-K5 from ``temporal_latticenet_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship main path gives it (inputs taken from a full-width lattice
   build), with its device time, its memory bound, the plain version's
   device time and, where one PyTorch call computes the same function, that
   call's device time.  Device times are the summed durations of the
   kernels a call launches, from ``torch.profiler``; ``wall_ms`` beside them
   is the CUDA-event time of back-to-back calls, host launch overhead
   included; ``device_ops_per_call`` counts the kernels, copies and memsets
   of one call.  K2's float32 sums run at the coarsen splats' shapes and at
   the finefy slices' backward shapes, then at the look-back's edge cases
   (one run over every row, fewer rows than a tile, a ragged last tile);
   K3 also takes shuffled, repeated, mid-run and out-of-range tails; every
   float32 sum must equal a second call bit for bit; K4 (on the same
   look-back) runs at the forward's shape, beside K2's int32 max on the
   sign-flipped bits (K4's function on K2's fenced descriptors), then at
   the same edge cases, at C = 3 and at the training step's summary-scan
   shape; the two-level tail max that K5 (the windowed max) feeds must also
   equal K4's full-scan tails;
4. the flagship 4-frame offline sequence forward at bench geometry (131,072
   padded points per frame, capacities 49152/24576/12288, trims 36864 and
   40960, sigma 0.6, seeded random weights), with the launch count of every
   kernel during one forward and the median seconds per sequence;
5. where the forward's time goes: its stages by host clock around
   synchronised calls (lattice build, batched pointnet, per-frame network),
   and under ``torch.profiler`` the device time per sequence of every kernel
   name (the hand-written kernels among them), the launches per sequence
   and the device's busy share of the wall time;
6. the same forward on the card and on the CPU at a reduced geometry:
   integer lattice structure equal, log-probabilities within bf16 tolerance;
7. the forward on the packed route (``TLN_MAXSCAN_PACKED=1``, the JAX
   package's switch: the pointnet max through K5 and K4): the reduced
   pointnet tensor bit-equal to the default route's, the largest
   log-probability difference, and the launches of every kernel;
8. the flagship training step at full width on the packed route (BPTT
   through the 4 frames with full remat, 0.5 Lovász + 0.5 NLL, AdamW with
   amsgrad, lr 1e-3, weight decay 1e-3): one warm step and
   ``TRAIN_STEPS`` timed steps on one batch, with seconds per step, peak
   device memory, loss and gradient norms per step, the launches of every
   kernel in one step, and under ``torch.profiler`` the device time per
   step of every hand-written kernel and the device's busy share;
9. the training step's gradients on the card and on the CPU at the reduced
   geometry, within the bf16 tolerance of the CPU test against the JAX
   package;
10. streaming (frame-at-a-time) serving at full width: the geometry of
    ``scripts/bench_streaming.py`` (phase 4's data and weights, capacities
    49152/24576/12288 without trims), through the plain path
    (``make_streaming_inference``: every frame's structures built in full)
    and the incremental one (``make_streaming_inference_incremental``,
    ``max_new`` 8192).  Each path: the launches of every kernel over one
    counted sequence (K1 once per frame), ``STREAM_SEQS`` sequences with
    the milliseconds of every frame (host clock, synchronised around each
    frame), the host syncs inside the frames (``torch.cuda`` sync debug
    mode), the device time per frame by kernel name and the busy share
    under ``torch.profiler``, peak memory, and each level's growth per
    frame.  The incremental path must not overflow, and the final frame's
    log-probabilities must agree with the offline forward's within the bf16
    tolerance, equal each other, and equal a second run's;
11. the streaming path on the card and on the CPU at the reduced geometry
    without trims: vertex tables, row indices, neighbor tables and corner
    indices of every frame equal, log-probabilities of both paths within
    the bf16 tolerance, and two streams stepped together on the card equal
    to each stream alone;
12. lstm-maxpool-cga-linear (every other fusion kind, and the early
    maxpool) at phase 4's geometry, bf16, batched pointnet: the launches of
    every kernel in one forward (K1-K4), ``CONFIG_ITERS`` timed forwards,
    the device time and launches per sequence, one warm and
    ``CONFIG_STEPS`` timed training steps on the default (K4) route with
    their peak memory and device time, and card vs CPU at the reduced
    geometry;
13. BASELINE configs 1-3 at the same geometry: one frame with
    ``sequence_learning=False``; the same model on three scans
    concatenated into one cloud of 3 x 131,072 padded points (no vertex
    overflow); gru-gru-gru-gru over 3 frames.  Each: kernel launches (K1-K4
    each at least once), seconds and device time per forward, and card vs
    CPU on the same cut of phase 6's reduced sequence (config 2: one cloud
    of 3 x 4,096 points);
14. the flagship's weights in float32 on the non-batched route with
    ``reference_bary_quirk`` (the per-frame float32 scatter max and
    argmax; K1-K3): launches, seconds and device time per sequence, its
    log-probabilities beside the bf16 flagship's (reported, not gated), and
    card vs CPU at the reduced geometry: the last frame's pointnet maxima
    within 1e-4 (the entries whose winning row differs counted), the
    log-probabilities within 1e-2;
15. phase 8 also reports the deform slice's gather backward
    (``indexing_backward_kernel``, once a 21.48 ms launch): no single
    launch of it may take over 1 ms;
16. one JSON line with the kernels, the device line, and the result line
    ``{"ok": true, "device": {...}}`` last.

Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside the tensor cores

FLAGSHIP_RT = dict(max_points=131072, capacity_level0=49152,
                   capacity_decay=0.5, min_capacity=8192, sigma=0.6,
                   trim_capacity_level0=36864, final_capacity_level0=40960)
SMALL_RT = dict(max_points=4096, capacity_level0=16384, capacity_decay=0.5,
                min_capacity=10240, sigma=0.6, trim_capacity_level0=12288,
                final_capacity_level0=15360)
FRAMES = 4
KERNEL_ITERS = 20      # calls per kernel timing (plain versions: 1/10)
FWD_ITERS = 20         # timed full-width forwards after the counted one
PROFILE_FORWARDS = 3   # forwards under torch.profiler
STAGE_REPS = 5         # synchronised calls per stage timing
TOP_KERNELS = 25       # kernel names listed by device time
# bf16 network held against itself on another device: both sides round the
# same operands to bf16 and sum in float32 in different orders, and a
# last-bit difference can flip a later bf16 rounding (the same tolerance
# as the CPU test against the JAX package)
LOGP_ATOL = 0.1
ARGMAX_AGREE = 0.99
TRAIN_STEPS = 6        # timed training steps after the warm one
PROFILE_STEPS = 2      # training steps under torch.profiler
# training step held against itself on the CPU: the tolerance of the CPU
# test against the JAX package (tests/test_torch_train.py), for the same
# reason as LOGP_ATOL, with operand gradients rounded to bf16 as well
LOSS_ATOL = 1e-2
GRAD_COSINE = 0.99
NORM_RTOL = 0.02
# parameters no forward reads (AFlow's conv weight, kept for the checkpoint
# schema): their gradient is zero, in the JAX package too
UNREAD_PARAMS = ("AFLOW.weight",)
# streaming serving: scripts/bench_streaming.py:42-43 (no trims)
STREAM_RT = dict(max_points=131072, capacity_level0=49152,
                 capacity_decay=0.5, min_capacity=8192, sigma=0.6)
MAX_NEW = 8192         # the incremental path's growth bound per frame
STREAM_SEQS = 12       # timed sequences per streaming path
PROFILE_STREAM_SEQS = 2
# the sorted accumulate of index_put_ (autograd's gather backward and the
# port's segment_sum on CUDA): no single launch of it in the training step
# may take longer (the deform slice's gather backward took 21.48 ms)
DEFORM_GATHER_BWD = "indexing_backward_kernel"
DEFORM_GATHER_BWD_MS = 1.0
# phases 12-15: the other model configurations at the bench geometry
ALL_KINDS = ("lstm", "maxpool", "cga", "linear")
CONFIG_ITERS = 10      # timed forwards per configuration
CONFIG_PROFILE = 2     # forwards per configuration under torch.profiler
CONFIG_STEPS = 3       # timed training steps of the all-kinds model
# the float32 per-frame route held against itself on the CPU: float32
# products and sums in other orders.  The last frame's pointnet maxima
# (measured 1.3e-5, no winning row changed) and the log-probabilities after
# 19 lattice convolutions over 4 frames of random-weight activations
# (measured 0.00245)
F32_MAX_ATOL = 1e-4
F32_LOGP_ATOL = 1e-2

KERNELS = {
    "fused_simplex_pack": dict(
        source="temporal_latticenet_tpu_torch/csrc/fused_simplex.cu",
        replaces="temporal_latticenet_tpu/ops/pallas_simplex.py:44"),
    "sorted_segment_scan": dict(
        source="temporal_latticenet_tpu_torch/csrc/seg_scan.cu",
        replaces="temporal_latticenet_tpu/ops/pallas_scan.py:281"),
    "seg_sum_tails": dict(
        source="temporal_latticenet_tpu_torch/csrc/seg_sum_tails.cu",
        replaces="temporal_latticenet_tpu/ops/pallas_scan.py:338"),
    "sorted_segment_max_u32": dict(
        source="temporal_latticenet_tpu_torch/csrc/seg_max.cu",
        replaces="temporal_latticenet_tpu/ops/pallas_scan.py:71"),
    "sorted_segment_max_window": dict(
        source="temporal_latticenet_tpu_torch/csrc/seg_max_window.cu",
        replaces="temporal_latticenet_tpu/ops/pallas_scan.py:111"),
}
# the kernels the default-route forward launches (K5 only on the packed
# route)
FORWARD_KERNELS = ("fused_simplex_pack", "sorted_segment_scan",
                   "seg_sum_tails", "sorted_segment_max_u32")


@contextlib.contextmanager
def packed_route():
    """``TLN_MAXSCAN_PACKED=1`` for the calls inside: the pointnet max takes
    the two-level route on K5 and K4."""
    old = os.environ.get("TLN_MAXSCAN_PACKED")
    os.environ["TLN_MAXSCAN_PACKED"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["TLN_MAXSCAN_PACKED"]
        else:
            os.environ["TLN_MAXSCAN_PACKED"] = old


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn, iters: int, reps: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call: host launch overhead included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_events(fn, calls: int):
    """The device-side events (kernels, copies, fills) of ``calls`` calls of
    ``fn`` under ``torch.profiler``, and the wall microseconds of the
    window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return events, wall_us


def device_ms(fn, iters: int):
    """Device time of one call: the summed durations of the device work it
    launches, mean over ``iters`` calls after one warm-up call; the device
    operations (kernels, copies, memsets) of one call; the events."""
    fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no device events at all
    for _ in range(3):
        events, _ = device_events(fn, iters)
        if events:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device work")
    return (sum(e.time_range.elapsed_us() for e in events) / iters / 1e3,
            len(events) / iters, events)


def split_ms(events, iters: int) -> dict:
    """Device ms per call of each kernel name (memsets under "Memset")."""
    out = {}
    for e in events:
        name = re.sub(r"^void ", "", e.name).split("(")[0][:48]
        ms = e.time_range.elapsed_us() / iters / 1e3
        out[name] = out.get(name, 0.0) + ms
    return out


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_lengths(ids: torch.Tensor) -> torch.Tensor:
    """Length of each row's run (for the summation-error tolerance)."""
    _, inverse, counts = torch.unique_consecutive(
        ids, return_inverse=True, return_counts=True)
    return counts[inverse]


def sum_tolerance(plain, plain_abs, run_len) -> torch.Tensor:
    """Recursive float32 summation in any order: |error| <= (n - 1) u sum|x|
    for a run of n rows (u = 2^-24); the plain version sums in float64 and
    rounds once (u/2), and sum|x| is itself rounded: (n + 1) u sum|x|."""
    n = run_len.to(torch.float64)[:, None]
    return ((n + 1) * 2.0 ** -24) * plain_abs.double()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at main-path shapes
# ---------------------------------------------------------------------------

def kernel_inputs(dev, data):
    """Real main-path operands: the full-width lattice built on the card as
    the forward builds it, and the final frame's trimmed links."""
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.ops import permutohedral as pm
    from temporal_latticenet_tpu_torch.ops import seq_lattice as sl
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice

    rt = RuntimeConfig(**FLAGSHIP_RT)
    pos, val, mask = (torch.as_tensor(a, device=dev) for a in data)
    lat, _, final_caps = sequence_lattice(ModelConfig(), rt, pos, val, mask)
    final = sl.trim_sequence_lattice(lat, final_caps)
    t, p = mask.shape
    y = pm.scale_positions(pos.reshape(t * p, 3), rt.sigma).contiguous()
    return dict(y=y, mask=mask.reshape(-1).contiguous(), spn=lat.sorted_pn,
                links=final.links, p=p)


def check_kernels(dev, inp):
    from temporal_latticenet_tpu_torch.ops import fused_simplex as fs
    from temporal_latticenet_tpu_torch.ops import seg_scan as ss
    from temporal_latticenet_tpu_torch.ops import segment as tseg

    g = torch.Generator(device=dev).manual_seed(0)
    spn = inp["spn"]
    q = spn.head_count.shape[0]
    ids_vf = spn.head_count
    results, cases = {}, []

    def case(name, label, kernel, plain, library, nbytes, ops, compare):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok, tol = compare(got, want)
        bms, by = bound(nbytes, ops)
        plain_iters = max(1, KERNEL_ITERS // 10)
        ms, ops, events = device_ms(kernel, KERNEL_ITERS)
        rec = dict(kernel=name, case=label, max_abs_err=err, tolerance=tol,
                   ok=bool(ok), ms=ms, device_ops_per_call=ops,
                   split_ms=split_ms(events, KERNEL_ITERS),
                   wall_ms=wall_ms(kernel, KERNEL_ITERS),
                   plain_ms=device_ms(plain, plain_iters)[0],
                   plain_wall_ms=wall_ms(plain, plain_iters),
                   library_ms=(device_ms(library, KERNEL_ITERS)[0]
                               if library else None),
                   bound_ms=bms, bound_by=by)
        log(f"[kernel] {json.dumps(rec)}")
        cases.append(rec)
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain "
                                 f"version: max_abs_err {err} ({tol})")
        return rec

    def exact(got, want):
        same = torch.equal(got, want)
        err = 0.0 if same else float((got.double() - want.double()).abs().max())
        return err, same, "bit-equal"

    def summed(ids, x, kernel, tails=None):
        """Within the summation bound, and bit-equal to a second call."""
        def compare(got, want):
            rows = x.shape[0]
            if tails is None:
                absum = ss.sorted_segment_scan_plain(ids, x.abs(), "sum")
                run_len = run_lengths(ids)
            else:
                absum = ss.seg_sum_tails_plain(ids, x.abs(), tails)
                run_len = run_lengths(ids)[tails.clamp(0, rows - 1)]
            d = (got.double() - want.double()).abs()
            tol = sum_tolerance(want, absum, run_len)
            again = torch.equal(got, kernel())
            return (float(d.max()), bool((d <= tol).all()) and again,
                    "|err| <= (n+1) 2^-24 sum|x| per run of n rows; "
                    "bit-equal from call to call")
        return compare

    # K1: every point of the sequence
    y, mask = inp["y"], inp["mask"]
    n = y.shape[0]
    case("fused_simplex_pack", f"N={n}",
         lambda: fs.fused_simplex_pack(y, mask),
         lambda: fs.fused_simplex_pack_plain(y, mask), None,
         n * (12 + 1) + n * 4 * (8 + 4), n * 150,
         lambda a, b: (max(exact(a[0], b[0])[0], exact(a[1], b[1])[0]),
                       torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                       "keys and bary bit-equal"))

    # K2 sum, one run without ids: the union's int32 cumsums (x in, out)
    heads = spn.head_vf.to(torch.int32)[:, None].contiguous()
    case("sorted_segment_scan", f"sum int32 one run, no ids, Q={q} C=1",
         lambda: ss.sorted_segment_scan(None, heads, "sum"),
         lambda: ss.sorted_segment_scan_plain(None, heads, "sum"),
         lambda: torch.cumsum(heads, dim=0, dtype=torch.int32),
         q * 4 * 2, q, exact)
    # K2 first: birth propagation over sorted runs
    frame = (spn.so // (inp["p"] * 4)).to(torch.int32)[:, None].contiguous()
    case("sorted_segment_scan", f"first int32 Q={q} C=1",
         lambda: ss.sorted_segment_scan(ids_vf, frame, "first"),
         lambda: ss.sorted_segment_scan_plain(ids_vf, frame, "first"), None,
         q * 4 * 3, q, exact)
    # K2 sum float32 on the final frame's links: the coarsen splats (64
    # channels over link 0, 128 over link 1) and the finefy slices'
    # backward (128-channel cotangents over link 1, then link 0)
    link0, link1 = inp["links"]
    for use, link, c in (("coarsen splat", link0, 64),
                         ("coarsen splat / slice backward", link1, 128),
                         ("slice backward", link0, 128)):
        dst = link.sorted_dst
        rows = torch.randn(dst.shape[0], c, generator=g, device=dev)
        m = dst.shape[0]

        def k2():
            return ss.sorted_segment_scan(dst, rows, "sum")
        case("sorted_segment_scan", f"{use}: sum float32 Q={m} C={c}", k2,
             lambda: ss.sorted_segment_scan_plain(dst, rows, "sum"), None,
             m * 4 + 2 * m * c * 4, m * c, summed(dst, rows, k2))
    # K2 edge cases of the look-back: one run over every row (with ids, so
    # each tile waits on the one before it), the largest float32 input as
    # one run, fewer rows than one tile, a ragged last tile
    zeros = torch.zeros(q, dtype=torch.int32, device=dev)
    case("sorted_segment_scan", f"sum int32 one run, zero ids, Q={q} C=1",
         lambda: ss.sorted_segment_scan(zeros, heads, "sum"),
         lambda: ss.sorted_segment_scan_plain(zeros, heads, "sum"),
         lambda: torch.cumsum(heads, dim=0, dtype=torch.int32),
         q * 4 * 3, q, exact)
    m = link0.sorted_dst.shape[0]
    one = zeros[:m]
    big = torch.randn(m, 128, generator=g, device=dev)

    def k2_one():
        return ss.sorted_segment_scan(one, big, "sum")
    case("sorted_segment_scan", f"sum float32 one run Q={m} C=128", k2_one,
         lambda: ss.sorted_segment_scan_plain(one, big, "sum"),
         lambda: torch.cumsum(big, dim=0),
         m * 4 + 2 * m * 128 * 4, m * 128, summed(one, big, k2_one))
    for m, c in ((100, 1), (100, 128), (4096 * 3 + 17, 1), (128 * 9 + 5, 128),
                 (256 * 5 + 3, 64)):
        ids = ids_vf[:m].contiguous()
        small = torch.randn(m, c, generator=g, device=dev)

        def k2_edge():
            return ss.sorted_segment_scan(ids, small, "sum")
        case("sorted_segment_scan", f"edge: sum float32 Q={m} C={c}",
             k2_edge, lambda: ss.sorted_segment_scan_plain(ids, small, "sum"),
             None, m * 4 + 2 * m * c * 4, m * c, summed(ids, small, k2_edge))

    # K3: per-(vertex, frame) position sums at the bucket tails
    n_runs = int(ids_vf[-1]) + 1
    live = spn.live.to(torch.float32)[:, None]
    x4 = torch.cat([spn.rel * live, live], dim=1).contiguous()
    tails = spn.tailpos.reshape(-1).contiguous()
    b = tails.shape[0]
    # the rows the function must read: those of runs that end at a tail
    run_ids, run_len = torch.unique_consecutive(ids_vf, return_counts=True)
    covered = int(run_len[torch.isin(run_ids, ids_vf[tails])].sum())

    def k3():
        return ss.seg_sum_tails(ids_vf, x4, tails)
    case("seg_sum_tails", f"Q={q} C=4 tails={b}", k3,
         lambda: ss.seg_sum_tails_plain(ids_vf, x4, tails),
         lambda: torch.zeros(n_runs, 4, device=dev).index_add_(
             0, ids_vf.long(), x4),
         covered * (4 + 16) + b * 8 + b * 16, covered * 4,
         summed(ids_vf, x4, k3, tails))
    # the contract's other tails: shuffled, repeated, mid-run, out of range
    odd = torch.cat([tails[torch.randperm(b, generator=g, device=dev)],
                     tails[:1000], tails[:1000] - 1,
                     torch.tensor([-1, q, 10 * q, 0, q - 1], device=dev)])
    bo = odd.shape[0]

    def k3_odd():
        return ss.seg_sum_tails(ids_vf, x4, odd)
    case("seg_sum_tails", f"odd tails: Q={q} C=4 tails={bo}", k3_odd,
         lambda: ss.seg_sum_tails_plain(ids_vf, x4, odd), None,
         q * (4 + 16) + bo * 8 + bo * 16, q * 4,
         summed(ids_vf, x4, k3_odd, odd))

    # K4: the batched pointnet's packed (bf16 | u16 bary) running max
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (q, 64), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    flipped = bits ^ torch.tensor(-2 ** 31, dtype=torch.int32, device=dev)
    idx64 = ids_vf.long()[:, None].expand(q, 64)
    rec = case("sorted_segment_max_u32", f"Q={q} C=64",
               lambda: ss.sorted_segment_max_u32(ids_vf, bits),
               lambda: ss.sorted_segment_max_u32_plain(ids_vf, bits),
               lambda: torch.full((n_runs, 64), -2 ** 31, dtype=torch.int32,
                                  device=dev).scatter_reduce_(
                   0, idx64, flipped, "amax"),
               q * 4 + 2 * q * 64 * 4, q * 64, exact)
    # the ids' runs: a tile's look-back stops at its predecessor unless a
    # run is longer than a tile (256 rows)
    rec["rows_per_run"] = q / n_runs
    rec["longest_run"] = int(run_len.max())
    rec["rows_in_runs_over_256"] = int(run_len[run_len > 256].sum())
    # a yardstick, not the same function: copying the values alone
    copy_out = torch.empty_like(bits)
    rec["copy_ms"] = device_ms(lambda: copy_out.copy_(bits), KERNEL_ITERS)[0]
    log(f"[kernel] K4's ids: {rec['rows_per_run']} rows per run, the "
        f"longest {rec['longest_run']}, {rec['rows_in_runs_over_256']} rows "
        f"in runs over 256; a copy of its values: {rec['copy_ms']} device ms")
    # K4's function on K2's fenced descriptors (values, fence, status): K2's
    # int32 max on the sign-flipped bits, what K4's channel words are for
    case("sorted_segment_scan",
         f"K4's function on K2's protocol: max int32 of the sign-flipped "
         f"bits, Q={q} C=64",
         lambda: ss.sorted_segment_scan(ids_vf, flipped, "max"),
         lambda: ss.sorted_segment_scan_plain(ids_vf, flipped, "max"), None,
         q * 4 + 2 * q * 64 * 4, q * 64, exact)
    # K4's look-back edge cases: one run over every row (each tile waits on
    # the ones before it; `torch.cummax` computes the same function), runs
    # of 16 rows that start at the strips (no tile looks back), fewer rows
    # than a tile, a ragged last tile, C = 3 (4-byte vectors), and the
    # training step's summary scan over every 16th row (the packed route)
    strips = torch.arange(q, device=dev, dtype=torch.int32) // 16
    for label, ids, x, library in (
            (f"one run, zero ids, Q={q} C=64", zeros, bits,
             lambda: torch.cummax(flipped, dim=0)),
            (f"no look-back: runs of 16 rows at the strips, Q={q} C=64",
             strips, bits, None),
            ("Q=100 C=64", ids_vf[:100], bits[:100], None),
            (f"ragged last tile, Q={256 * 7 + 3} C=64", ids_vf[:256 * 7 + 3],
             bits[:256 * 7 + 3], None),
            (f"Q={q} C=3", ids_vf, bits[:, :3], None),
            (f"summary scan, Q={q // 16} C=64", ids_vf[15::16], bits[15::16],
             None)):
        ids, x = ids.contiguous(), x.contiguous()
        r, c = x.shape
        case("sorted_segment_max_u32", f"edge: {label}",
             lambda: ss.sorted_segment_max_u32(ids, x),
             lambda: ss.sorted_segment_max_u32_plain(ids, x), library,
             r * 4 + 2 * r * c * 4, r * c, exact)

    # K5: the packed route's windowed max on the same rows (window 8: every
    # row covers its last 16 same-run rows), bit-equal to its plain version
    # (which the CPU tests hold to the coverage contract against the Pallas
    # kernel), then the two-level tail max it feeds, which must equal K4's
    # full-scan tails bit for bit
    window = tseg.CHUNK // 2
    # comparisons this data needs: each row folds in min(its rank in its
    # run, 2W - 1) earlier rows
    rank = torch.arange(q, device=dev) - ss._head_positions(ids_vf)
    folds = int(rank.clamp(max=2 * window - 1).sum()) * 64
    case("sorted_segment_max_window", f"Q={q} C=64 window={window}",
         lambda: ss.sorted_segment_max_window(ids_vf, bits, window),
         lambda: ss.sorted_segment_max_window_plain(ids_vf, bits, window),
         None, q * 4 + 2 * q * 64 * 4, folds, exact)
    k4_tails = ss.sorted_segment_max_u32(ids_vf, bits)[tails]

    def tails_equal(got, want):
        err, same, _ = exact(got, want)
        return (err, same and torch.equal(got, k4_tails),
                "bit-equal to the plain full-run max and to K4's tails")
    case("sorted_segment_max_window",
         f"two-level tails (K5 + K4 summary) Q={q} C=64 tails={b}",
         lambda: tseg._seg_max_tails_twolevel(ids_vf, bits, tails),
         lambda: ss.sorted_segment_max_u32_plain(ids_vf, bits)[tails],
         lambda: torch.full((n_runs, 64), -2 ** 31, dtype=torch.int32,
                            device=dev).scatter_reduce_(
             0, idx64, flipped, "amax"),
         q * 4 + q * 64 * 4 + b * 8 + b * 64 * 4, q * 64, tails_equal)

    # one entry per kernel: the times of its first case above, the largest
    # error over all of its cases, and the cases themselves
    for name in KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        results[name] = dict(mine[0], cases=mine,
                             max_abs_err=max(c["max_abs_err"] for c in mine))
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the flagship forward
# ---------------------------------------------------------------------------

def lidar_labelled(p: int, seed: int = 0):
    """(positions, values, labels, mask) of a FRAMES-frame LiDAR-like
    sequence."""
    from temporal_latticenet_tpu_torch.data.lidar_like import lidar_sequence
    return lidar_sequence(np.random.default_rng(seed), frames=FRAMES,
                          max_points=p, n_az=p // 64)


def lidar(p: int, seed: int = 0):
    pos, val, _, mask = lidar_labelled(p, seed)
    return pos, val, mask


def make_forward(rt_kw, device, state_dict=None, cfg=None):
    """The model of ``cfg`` (default: the flagship) from seed 0 or
    ``state_dict``, its no-gradient offline forward, and the runtime."""
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
    from temporal_latticenet_tpu_torch.train.engine import make_sequence_forward

    cfg, rt = cfg or ModelConfig(), RuntimeConfig(**rt_kw)
    model = LNNSeq(cfg, rt, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.eval()
    return model, make_sequence_forward(model, cfg, rt), rt


def check_output(logp, aux, rt, mask_last):
    logp = logp.float()
    valid = torch.as_tensor(mask_last, device=logp.device)
    lp = logp[valid]
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite log-probabilities")
    row_sum = lp.exp().sum(-1)
    if float((row_sum - 1).abs().max()) > 1e-3:
        raise AssertionError("log-probabilities do not normalise")
    caps = torch.tensor(rt.capacities(2))
    occ = aux["occupancy"].cpu()
    if not bool((occ < caps).all()):
        raise AssertionError(f"occupancy {occ.tolist()} reaches the caps "
                             f"{caps.tolist()}")
    if bool(aux["trim_overflow"]):
        raise AssertionError("trim overflow")
    return occ.tolist()


def flagship_forward(dev, data, fwd, rt):
    from temporal_latticenet_tpu_torch.ops import _cuda

    pos, val, mask = data
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    logp, _, aux = fwd(pos, val, mask)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    occ = check_output(logp, aux, rt, mask[-1])
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    secs = []
    for _ in range(FWD_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(pos, val, mask)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    s = statistics.median(secs)
    pts = FRAMES * float(mask.sum(1).mean())
    return dict(launches=launches, occupancy=occ, seconds_per_seq=s,
                seconds_all=secs, points_per_s=pts / s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _timed(fn):
    out, secs = None, []
    for _ in range(STAGE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, statistics.median(secs)


def _busy_share(events, wall_us):
    """The union of the events' intervals over the wall time."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / wall_us


def hand_written(kernel_name: str):
    """Which of K1-K5 a device kernel name belongs to, or None.  K2 is
    ``seg_scan_lookback``; K3 its ``seg_sum_tails_scan`` and
    ``seg_sum_tails_gather``; K4 ``seg_max_lookback`` (K2, K3 and K4 share
    the look-back scan, each under a kernel name of its own).  The memsets
    of their tile states carry no kernel name and are not counted here."""
    if "simplex_kernel" in kernel_name:
        return "fused_simplex_pack"
    if "seg_max_window_kernel" in kernel_name:
        return "sorted_segment_max_window"
    if "seg_sum_tails_" in kernel_name:
        return "seg_sum_tails"
    if "seg_scan_lookback" in kernel_name:
        return "sorted_segment_scan"
    if "seg_max_lookback" in kernel_name:
        return "sorted_segment_max_u32"
    return None


def profile_forward(dev, data, model, fwd, rt):
    from temporal_latticenet_tpu_torch.config import ModelConfig
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice

    pos, val, mask = data
    pos_d, val_d, mask_d = (torch.as_tensor(a, device=dev) for a in data)
    with torch.no_grad():
        _, total = _timed(lambda: fwd(pos, val, mask))
        (lat, _, _), t_build = _timed(lambda: sequence_lattice(
            ModelConfig(), rt, pos_d, val_d, mask_d))
        _, t_pn = _timed(lambda: model.reduce_pointnet(lat, val_d))
    stages = dict(forward_s=total, lattice_build_s=t_build, pointnet_s=t_pn,
                  network_frames_s=total - t_build - t_pn)

    events, wall_us = device_events(lambda: fwd(pos, val, mask),
                                    PROFILE_FORWARDS)
    return dict(stages=stages, profiled_forwards=PROFILE_FORWARDS,
                **device_summary(events, wall_us, PROFILE_FORWARDS, "seq"))


def device_summary(events, wall_us, n: int, per: str) -> dict:
    """Device time, launches and busy share per call (``per``: "seq" or
    "step") of ``n`` profiled calls, by kernel name and for the
    hand-written kernels."""
    if not events:
        raise RuntimeError("torch.profiler recorded no device work")
    by_name, mine = {}, {}
    for e in events:
        us = e.time_range.elapsed_us()
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += us
        d[1] += 1
        k = hand_written(e.name)
        if k:
            m = mine.setdefault(k, [0.0, 0])
            m[0] += us
            m[1] += 1
    dev_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        f"wall_ms_per_{per}": wall_us / n / 1e3,
        f"device_ms_per_{per}": dev_us / n / 1e3,
        f"device_launches_per_{per}": len(events) / n,
        # the memsets among them (K2's and K3's tile states, and any other)
        f"memsets_per_{per}": sum(v[1] for k, v in by_name.items()
                                  if k.startswith("Memset")) / n,
        "device_busy_share": _busy_share(events, wall_us),
        "hand_written": {k: {f"device_ms_per_{per}": v[0] / n / 1e3,
                             f"device_launches_per_{per}": v[1] / n}
                         for k, v in mine.items()},
        "top_kernels": [{"name": k[:120], f"ms_per_{per}": v[0] / n / 1e3,
                         "share_of_device": v[0] / dev_us,
                         f"calls_per_{per}": v[1] / n} for k, v in top]}


def largest_launches(events, n: int = 8):
    """The ``n`` longest single device events, by name and ms."""
    top = sorted(events, key=lambda e: -e.time_range.elapsed_us())[:n]
    return [{"name": e.name[:120], "ms": e.time_range.elapsed_us() / 1e3}
            for e in top]


def named_entries(events, substring: str, calls: int) -> dict:
    """Launches and device ms per call, and the longest single launch, of
    the device events whose name holds ``substring``."""
    ms = [e.time_range.elapsed_us() / 1e3 for e in events
          if substring in e.name]
    return dict(name=substring, launches_per_call=len(ms) / calls,
                ms_per_call=sum(ms) / calls, longest_ms=max(ms, default=0.0))


def _structure_diff(a, b, prefix=""):
    """Names of integer/bool fields that differ, and the largest float
    difference, between two lattices (dataclasses of tensors)."""
    bad, fmax = [], 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        name = prefix + f.name
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(name)
        elif dataclasses.is_dataclass(x):
            sub_bad, sub_max = _structure_diff(x, y, name + ".")
            bad += sub_bad
            fmax = max(fmax, sub_max)
        elif isinstance(x, tuple):
            for i, (u, v) in enumerate(zip(x, y)):
                sub_bad, sub_max = _structure_diff(u, v, f"{name}{i}.")
                bad += sub_bad
                fmax = max(fmax, sub_max)
        elif x.dtype.is_floating_point:
            fmax = max(fmax, float((x.float().cpu() - y.float().cpu())
                                   .abs().max()) if x.numel() else 0.0)
        elif not torch.equal(x.cpu(), y.cpu()):
            bad.append(name)
    return bad, fmax


def card_vs_cpu(dev, cfg=None, rt_kw=SMALL_RT, atol=LOGP_ATOL, data=None):
    """The forward of ``cfg`` (default: the flagship) on the card and on the
    CPU at the reduced geometry, on ``data`` (default: the reduced
    sequence), log-probabilities within ``atol``."""
    from temporal_latticenet_tpu_torch.ops import seq_lattice as sl

    if data is None:
        data = lidar(rt_kw["max_points"])
    cpu_model, cpu_fwd, rt = make_forward(rt_kw, "cpu", cfg=cfg)
    _, dev_fwd, _ = make_forward(rt_kw, dev, cpu_model.state_dict(), cfg)
    lats = [sl.build_sequence_lattice(
        torch.as_tensor(data[0], device=d), torch.as_tensor(data[2], device=d),
        rt.sigma, rt.capacities(2), 2,
        pn_values=torch.as_tensor(data[1], device=d), want_row_rel=True)
        for d in ("cpu", dev)]
    bad, float_max = _structure_diff(*lats)
    if bad:
        raise AssertionError(f"lattice fields differ card vs CPU: {bad}")
    lp_cpu, _, aux_c = cpu_fwd(*data)
    lp_dev, _, aux_d = dev_fwd(*data)
    check_output(lp_dev, aux_d, rt, data[2][-1])
    valid = torch.as_tensor(data[2][-1])
    a, b = lp_cpu[valid], lp_dev.cpu()[valid]
    d = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    if not torch.equal(aux_c["point_vertex"], aux_d["point_vertex"].cpu()):
        raise AssertionError("point_vertex differs card vs CPU")
    if d > atol or agree < ARGMAX_AGREE:
        raise AssertionError(f"log-probabilities differ card vs CPU: max "
                             f"{d}, argmax agreement {agree}")
    return dict(points=rt_kw["max_points"], lattice_float_max_diff=float_max,
                logp_max_abs_diff=d, argmax_agreement=agree, logp_atol=atol)


# ---------------------------------------------------------------------------
# phase 7: the forward on the packed route
# ---------------------------------------------------------------------------

def packed_forward(dev, data, model, fwd, rt):
    from temporal_latticenet_tpu_torch.config import ModelConfig
    from temporal_latticenet_tpu_torch.ops import _cuda
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice

    pos, val, mask = data
    pos_d, val_d, mask_d = (torch.as_tensor(a, device=dev) for a in data)
    with torch.no_grad():
        lat, _, _ = sequence_lattice(ModelConfig(), rt, pos_d, val_d, mask_d)
        red_k4 = model.reduce_pointnet(lat, val_d)
        logp_k4, _, _ = fwd(pos, val, mask)
        with packed_route():
            red_k5 = model.reduce_pointnet(lat, val_d)
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            logp_k5, _, aux = fwd(pos, val, mask)
            torch.cuda.synchronize()
            launches = _cuda.launch_counts()
    check_output(logp_k5, aux, rt, mask[-1])
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the packed route: "
                             f"{missing}")
    if not torch.equal(red_k4, red_k5):
        raise AssertionError("the packed route's reduced pointnet tensor "
                             "differs from the default route's")
    valid = torch.as_tensor(mask[-1], device=dev)
    d = float((logp_k5 - logp_k4)[valid].abs().max())
    if d > LOGP_ATOL:
        raise AssertionError(f"log-probabilities differ between the routes: "
                             f"{d}")
    return dict(launches=launches, reduced_bit_equal=True,
                logp_max_abs_diff=d)


# ---------------------------------------------------------------------------
# phases 8 and 9: the training step
# ---------------------------------------------------------------------------

def make_trainer(rt_kw, device, state_dict=None, cfg=None):
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.train import engine

    cfg = cfg or ModelConfig()
    rt = RuntimeConfig(**rt_kw, remat_mode="full")
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3, seed=0,
                                             device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    train_step, _ = engine.make_train_step(model, cfg, rt)
    return model, state, train_step


def train_batch(p: int, device):
    from temporal_latticenet_tpu_torch.train.engine import SeqBatch
    return SeqBatch(*(torch.as_tensor(a, device=device)[None]
                      for a in lidar_labelled(p)))


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[2]]


def train_flagship(dev, forward_launches):
    from temporal_latticenet_tpu_torch.ops import _cuda

    model, state, train_step = make_trainer(FLAGSHIP_RT, dev)
    batch = train_batch(FLAGSHIP_RT["max_points"], dev)
    losses, norms, secs = [], [], []
    with packed_route():
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        state, logp, m = train_step(state, batch, 1.0)       # warm step
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, logp, m = train_step(state, batch, 1.0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        param_norms = {k: float(p.grad.float().norm())
                       for k, p in model.named_parameters()}
        events, wall_us = device_events(
            lambda: train_step(state, batch, 1.0), PROFILE_STEPS)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the training step: "
                             f"{missing}")
    if not launches["sorted_segment_scan"] > forward_launches.get(
            "sorted_segment_scan", 0):
        raise AssertionError("K2 launched no more often in the training step "
                             "than in the forward")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or gradient norm: {losses}, "
                             f"{norms}")
    dead = [k for k, v in param_norms.items()
            if not math.isfinite(v) or (v == 0 and not k.endswith(UNREAD_PARAMS))]
    if dead:
        raise AssertionError(f"zero or non-finite gradients: {dead}")
    if not bool(torch.isfinite(logp).all()):
        raise AssertionError("non-finite log-probabilities")
    # the deform slice's gather backward: one 21.5 ms launch of the sorted
    # accumulate while it was autograd's (every masked point's rows read
    # vertex 0); now a segment_sum that leaves those rows out
    gather_bwd = named_entries(events, DEFORM_GATHER_BWD, PROFILE_STEPS)
    if gather_bwd["longest_ms"] > DEFORM_GATHER_BWD_MS:
        raise AssertionError(f"a {DEFORM_GATHER_BWD} launch took "
                             f"{gather_bwd['longest_ms']} ms")
    return dict(steps=TRAIN_STEPS, seconds_per_step=statistics.median(secs),
                quartiles=quartiles(secs), seconds_all=secs,
                peak_mem_gb=peak_gb, losses=losses, grad_norms=norms,
                launches=launches, nr_vertices=int(m["nr_vertices"]),
                vertex_overflow=bool(m["vertex_overflow"]),
                param_grad_norm_min=min(v for k, v in param_norms.items()
                                        if not k.endswith(UNREAD_PARAMS)),
                profiled_steps=PROFILE_STEPS, deform_gather_backward=gather_bwd,
                largest_launches=largest_launches(events),
                **device_summary(events, wall_us, PROFILE_STEPS, "step"))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b) / (na * nb)


def train_card_vs_cpu(dev):
    cpu_model, _, cpu_step = make_trainer(SMALL_RT, "cpu")
    _, _, dev_step = make_trainer(SMALL_RT, dev, cpu_model.state_dict())
    p = SMALL_RT["max_points"]
    with packed_route():
        loss_c, g_c = cpu_step.grad_step(train_batch(p, "cpu"))
        loss_d, g_d = dev_step.grad_step(train_batch(p, dev))
    d_loss = abs(float(loss_c) - float(loss_d))
    cos = {k: _cosine(g_c[k], g_d[k].cpu()) for k in g_c}
    worst = min(cos, key=cos.get)
    n_c = math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_c.values()))
    n_d = math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_d.values()))
    if d_loss > LOSS_ATOL or cos[worst] < GRAD_COSINE \
            or abs(n_d - n_c) > NORM_RTOL * n_c:
        raise AssertionError(f"gradients differ card vs CPU: loss {d_loss}, "
                             f"cosine {cos[worst]} ({worst}), norms {n_d} vs "
                             f"{n_c}")
    return dict(points=p, loss_cpu=float(loss_c), loss_abs_diff=d_loss,
                min_grad_cosine=cos[worst], min_cosine_param=worst,
                grad_norm_cpu=n_c, grad_norm_card=n_d,
                tolerance=dict(loss=LOSS_ATOL, cosine=GRAD_COSINE,
                               norm_rtol=NORM_RTOL))


# ---------------------------------------------------------------------------
# phases 10 and 11: streaming serving
# ---------------------------------------------------------------------------

def stream_fns(model, rt_kw, incremental: bool, max_new: int = MAX_NEW):
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.train import engine

    cfg, rt = ModelConfig(), RuntimeConfig(**rt_kw)
    if incremental:
        return engine.make_streaming_inference_incremental(model, cfg, rt,
                                                           max_new)
    return engine.make_streaming_inference(model, cfg, rt)


def run_stream(fns, frames, times=None, counts=None):
    """One sequence through a streaming path (3 functions: plain; 4:
    incremental, full build on frame 0).  With ``times``, each frame's
    seconds, synchronised before and after it; with ``counts``, each
    frame's per-level table counts (device tensors).  Returns (logp, aux,
    the final carry)."""
    pos, val, mask = frames
    n = len(pos)
    plain = len(fns) == 3
    carry = (fns[0](),) if plain else fns[0]()
    out = None
    for t in range(n):
        if times is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if t == n - 1:
            out = fns[-1](pos[t], val[t], mask[t], *carry)
            carry = (out[2],) if plain else out[2:4]
        else:
            fn = fns[1] if plain or t == 0 else fns[2]
            res = fn(pos[t], val[t], mask[t], *carry)
            carry = (res,) if plain else res
        if times is not None:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if counts is not None:
            counts.append(torch.stack([tb.count for tb in carry[0].tables]))
    return out[0], out[-1], carry


def host_syncs(fn):
    """Calls inside ``fn`` that made the host wait for the device (the
    ``torch.cuda`` sync debug mode's warnings), counted by the innermost
    line of this repository on the stack that made them."""
    root = os.path.dirname(os.path.abspath(__file__))
    where = {}

    def record(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()
                if f.filename.startswith(root)
                and not f.filename.endswith("chip_smoke.py")]
        key = (f"{os.path.relpath(mine[-1].filename, root)}:"
               f"{mine[-1].lineno}" if mine else "outside the repository")
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return where


def check_stream_output(logp, aux, rt_kw, mask_last):
    from temporal_latticenet_tpu_torch.config import RuntimeConfig

    lp = logp.float()[torch.as_tensor(mask_last, device=logp.device)]
    if not bool(torch.isfinite(lp).all()):
        raise AssertionError("non-finite log-probabilities")
    if float((lp.exp().sum(-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("log-probabilities do not normalise")
    caps = torch.tensor(RuntimeConfig(**rt_kw).capacities(2))
    occ = aux["occupancy"].cpu()
    if not bool((occ < caps).all()):
        raise AssertionError(f"occupancy {occ.tolist()} reaches the caps "
                             f"{caps.tolist()}")
    return occ.tolist()


def logp_stats(a, b, mask_last):
    """How two final frames' log-probabilities differ on the valid points:
    the largest difference, its upper quantiles, the points over half the
    tolerance, and the argmax agreement."""
    valid = torch.as_tensor(mask_last, device=a.device)
    x, y = a[valid].float(), b.to(a.device)[valid].float()
    d = (x - y).abs().amax(-1)
    q = torch.quantile(d, torch.tensor([0.999, 0.9999], device=d.device))
    return dict(logp_max_abs_diff=float(d.max()),
                p999=float(q[0]), p9999=float(q[1]),
                points_over_half_atol=int((d > LOGP_ATOL / 2).sum()),
                points=int(d.numel()),
                argmax_agreement=float((x.argmax(-1) == y.argmax(-1))
                                       .float().mean()))


def agrees(st) -> bool:
    return st["logp_max_abs_diff"] <= LOGP_ATOL \
        and st["argmax_agreement"] >= ARGMAX_AGREE


def logp_agreement(a, b, mask_last, what):
    st = logp_stats(a, b, mask_last)
    if not agrees(st):
        raise AssertionError(f"{what}: {json.dumps(st)}")
    return st


def stream_path(dev, model, frames, incremental: bool):
    """Phase 10 for one streaming path at full width."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    n = len(frames[0])
    max_new = MAX_NEW
    while True:
        fns = stream_fns(model, STREAM_RT, incremental, max_new)
        run_stream(fns, frames)                      # warm-up
        if not incremental:
            break
        _, _, carry = run_stream(fns, frames)
        if not bool(carry[1].overflowed):
            break
        max_new *= 2                                 # reported below
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    counts = []
    logp, aux, carry = run_stream(fns, frames, counts=counts)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["fused_simplex_pack"] != n:
        raise AssertionError(f"K1 launched {launches['fused_simplex_pack']} "
                             f"times in {n} frames")
    occ = check_stream_output(logp, aux, STREAM_RT, frames[2][-1])
    overflowed = bool(carry[1].overflowed) if incremental else None
    if overflowed:
        raise AssertionError("the incremental path overflowed")
    levels = torch.stack(counts).cpu()
    growth = torch.diff(levels, dim=0,
                        prepend=torch.ones((1, levels.shape[1]),
                                           dtype=levels.dtype))
    syncs = host_syncs(lambda: run_stream(fns, frames))
    # no atomics on the path: the same frames give the same bits
    if not torch.equal(run_stream(fns, frames)[0], logp):
        raise AssertionError("a second run of the same sequence gave other "
                             "log-probabilities")

    secs = []
    for _ in range(STREAM_SEQS):
        run_stream(fns, frames, times=secs)
    ms = np.array(secs).reshape(STREAM_SEQS, n) * 1e3
    non_final, final = ms[:, :-1].ravel().tolist(), ms[:, -1].tolist()
    timing = dict(non_final_ms=statistics.median(non_final),
                  non_final_quartiles_ms=quartiles(non_final),
                  final_ms=statistics.median(final),
                  final_quartiles_ms=quartiles(final))
    if incremental:
        first, later = ms[:, 0].tolist(), ms[:, 1:-1].ravel().tolist()
        timing.update(first_frame_ms=statistics.median(first),
                      first_frame_quartiles_ms=quartiles(first),
                      later_non_final_ms=statistics.median(later),
                      later_non_final_quartiles_ms=quartiles(later))
    events, wall_us = device_events(
        lambda: run_stream(fns, frames, times=[]), PROFILE_STREAM_SEQS)
    return logp, dict(
        **timing, frame_ms_all=ms.tolist(), sequences=STREAM_SEQS,
        max_new=max_new if incremental else None, overflowed=overflowed,
        launches=launches,
        launches_per_frame={k: v / n for k, v in launches.items()},
        host_syncs_per_sequence=syncs, peak_mem_gb=peak_gb, occupancy=occ,
        counts_per_frame=levels.tolist(), growth_per_frame=growth.tolist(),
        profiled_sequences=PROFILE_STREAM_SEQS,
        **device_summary(events, wall_us, PROFILE_STREAM_SEQS * n, "frame"))


def streaming_flagship(dev, state_dict):
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq

    data = lidar(STREAM_RT["max_points"])
    frames = tuple(torch.as_tensor(a, device=dev) for a in data)
    model = LNNSeq(ModelConfig(), RuntimeConfig(**STREAM_RT), device=dev)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    _, offline, _ = make_forward(FLAGSHIP_RT, dev, state_dict)
    with torch.no_grad():
        logp_off = offline(*frames)[0]
    del offline
    logp_p, plain = stream_path(dev, model, frames, incremental=False)
    logp_i, inc = stream_path(dev, model, frames, incremental=True)
    last = data[2][-1]
    res = dict(plain=plain, incremental=inc,
               plain_vs_offline=logp_stats(logp_p, logp_off, last),
               incremental_vs_offline=logp_stats(logp_i, logp_off, last),
               incremental_bit_equal_plain=bool(torch.equal(logp_i, logp_p)),
               logp_atol=LOGP_ATOL, argmax_agree=ARGMAX_AGREE)
    bad = {k: res[k] for k in ("plain_vs_offline", "incremental_vs_offline")
           if not agrees(res[k])}
    if bad or not res["incremental_bit_equal_plain"]:
        raise AssertionError(f"streaming disagrees: {json.dumps(bad)}; "
                             f"incremental bit-equal to plain: "
                             f"{res['incremental_bit_equal_plain']}")
    return res


def _stream_structures(rt_kw, data, device):
    """Every frame's tables, row indices, neighbor tables and corner
    indices, streamed through the per-frame structure ops on ``device``."""
    from temporal_latticenet_tpu_torch.config import RuntimeConfig
    from temporal_latticenet_tpu_torch.ops import lattice_ops as lo
    from temporal_latticenet_tpu_torch.ops import vertex_table as vt

    rt = RuntimeConfig(**rt_kw)
    tabs = [vt.make_table(c, device) for c in rt.capacities(2)]
    out = []
    for pos, mask in zip(*(torch.as_tensor(a, device=device)
                           for a in (data[0], data[2]))):
        tabs[0], dist = lo.distribute(tabs[0], pos, mask, rt.sigma)
        rec = dict(row_vertex=dist.row_vertex, row_bary=dist.row_bary,
                   row_rel_pos=dist.row_rel_pos,
                   nbr0=lo.build_neighbor_table(tabs[0]))
        for i in range(2):
            tabs[i + 1], link = lo.grow_coarse_table(tabs[i], tabs[i + 1])
            rec[f"corner_idx{i}"] = link.corner_idx
            rec[f"nbr{i + 1}"] = lo.build_neighbor_table(tabs[i + 1])
        for l, tb in enumerate(tabs):
            for f in ("keys", "packed", "sorted_packed", "sorted_to_stable",
                      "count"):
                rec[f"table{l}.{f}"] = getattr(tb, f)
        out.append({k: (tuple(x.cpu() for x in v) if isinstance(v, tuple)
                        else v.cpu()) for k, v in rec.items()})
    return out


def streaming_card_vs_cpu(dev):
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
    from temporal_latticenet_tpu_torch.train import engine

    rt_kw = dict(SMALL_RT, trim_capacity_level0=0, final_capacity_level0=0)
    cfg, rt = ModelConfig(), RuntimeConfig(**rt_kw)
    data = lidar(rt_kw["max_points"])
    last = data[2][-1]
    a, b = (_stream_structures(rt_kw, data, d) for d in ("cpu", dev))
    floats = ("row_bary", "row_rel_pos")
    bad = sorted({f"frame {t}: {k}" for t, (x, y) in enumerate(zip(a, b))
                  for k in x if k not in floats
                  and not all(torch.equal(u, v) for u, v in zip(
                      x[k] if isinstance(x[k], tuple) else (x[k],),
                      y[k] if isinstance(y[k], tuple) else (y[k],)))})
    if bad:
        raise AssertionError(f"streaming structures differ card vs CPU: "
                             f"{bad}")
    # K1 computes the weights bit for bit; the local means are sums in
    # another order on each device
    float_diff = {k: max(float((x[k] - y[k]).abs().max())
                         for x, y in zip(a, b)) for k in floats}
    if float_diff["row_bary"] != 0.0:
        raise AssertionError(f"barycentric weights differ card vs CPU: "
                             f"{float_diff['row_bary']}")
    models = {"cpu": LNNSeq(cfg, rt, device="cpu", seed=0).eval()}
    models[dev] = LNNSeq(cfg, rt, device=dev).eval()
    models[dev].load_state_dict(models["cpu"].state_dict(), strict=True)
    res, logps = {}, {}
    for inc in (False, True):
        name = "incremental" if inc else "plain"
        outs = {d: run_stream(stream_fns(m, rt_kw, inc), data)
                for d, m in models.items()}
        logps[name] = outs[dev][0]
        check_stream_output(outs[dev][0], outs[dev][1], rt_kw, last)
        res[name] = logp_agreement(outs[dev][0], outs["cpu"][0].to(dev), last,
                                   f"{name} streaming card vs CPU")
        if inc:
            fc, fd = outs["cpu"][2][1], outs[dev][2][1]
            if bool(fd.overflowed) or bool(fc.overflowed):
                raise AssertionError("the incremental path overflowed")
            same = all(torch.equal(x.idx.cpu(), y.idx) and torch.equal(
                x.found.cpu(), y.found) for x, y in zip(fd.nbrs, fc.nbrs))
            same &= all(torch.equal(x.corner_idx.cpu(), y.corner_idx)
                        for x, y in zip(fd.links, fc.links))
            if not same:
                raise AssertionError("incremental structures differ card vs "
                                     "CPU")
    # two streams stepped together against each alone, on the card
    data2 = lidar(rt_kw["max_points"], seed=1)
    both = tuple(torch.as_tensor(np.stack([x, y], axis=1), device=dev)
                 for x, y in zip(data, data2))
    new_b, step_b, final_b = engine.make_streaming_inference_batched(
        models[dev], cfg, rt)
    carry = new_b(2)
    for t in range(len(data[0]) - 1):
        carry = step_b(both[0][t], both[1][t], both[2][t], carry)
    logp_b, _, _, _ = final_b(both[0][-1], both[1][-1], both[2][-1], carry)
    single = [logps["plain"], run_stream(stream_fns(models[dev], rt_kw,
                                                    False), data2)[0]]
    if not all(torch.equal(logp_b[i], single[i]) for i in range(2)):
        raise AssertionError("two streams stepped together differ from each "
                             "stream alone")
    return dict(points=rt_kw["max_points"], structures_equal=True,
                float_max_diff=float_diff, logp_atol=LOGP_ATOL, **res,
                batched_bit_equal=True)


# ---------------------------------------------------------------------------
# phases 12-15: the other model configurations
# ---------------------------------------------------------------------------

def model_config(**kw):
    from temporal_latticenet_tpu_torch.config import ModelConfig
    return ModelConfig(**kw)


def config_forward(data, fwd, rt, required):
    """One configuration's offline forward at full width: the launches of
    every kernel during one forward (each of ``required`` at least once),
    the output checked, ``CONFIG_ITERS`` timed forwards, and the device time
    per sequence under ``torch.profiler``.  Returns (logp, result)."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    pos, val, mask = data
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    logp, _, aux = fwd(pos, val, mask)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    occ = check_output(logp, aux, rt, mask[-1])
    if bool(aux["vertex_overflow"]):
        raise AssertionError("vertex overflow")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on this path: {missing}")
    secs = []
    for _ in range(CONFIG_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(pos, val, mask)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    events, wall_us = device_events(lambda: fwd(pos, val, mask),
                                    CONFIG_PROFILE)
    return logp, dict(
        launches=launches, occupancy=occ, frames=len(pos),
        points_per_frame=int(pos.shape[1]),
        seconds_per_seq=statistics.median(secs), quartiles=quartiles(secs),
        seconds_all=secs, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profiled_forwards=CONFIG_PROFILE,
        **device_summary(events, wall_us, CONFIG_PROFILE, "seq"))


def all_kinds(dev, data):
    """Phase 12: lstm-maxpool-cga-linear (every other fusion kind, and the
    early maxpool), 4 frames, bf16, batched pointnet (K1-K4): the forward,
    one training step on the default (K4) route, and card vs CPU."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    cfg = model_config(rnn_modules=ALL_KINDS)
    model, fwd, rt = make_forward(FLAGSHIP_RT, dev, cfg=cfg)
    _, res = config_forward(data, fwd, rt, FORWARD_KERNELS)
    del model, fwd
    torch.cuda.empty_cache()

    _, state, train_step = make_trainer(FLAGSHIP_RT, dev, cfg=cfg)
    batch = train_batch(FLAGSHIP_RT["max_points"], dev)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    state, _, m = train_step(state, batch, 1.0)              # warm step
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the training step: "
                             f"{missing}")
    losses, secs = [float(m["loss"])], []
    for _ in range(CONFIG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, m = train_step(state, batch, 1.0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    events, wall_us = device_events(lambda: train_step(state, batch, 1.0), 1)
    res["train"] = dict(
        launches=launches, losses=losses,
        seconds_per_step=statistics.median(secs), seconds_all=secs,
        peak_mem_gb=peak, largest_launches=largest_launches(events),
        deform_gather_backward=named_entries(events, DEFORM_GATHER_BWD, 1),
        **device_summary(events, wall_us, 1, "step"))
    del state, train_step
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = card_vs_cpu(dev, cfg)
    return res


def baseline_configs(dev, data):
    """Phase 13: BASELINE configs 1-3 at full width (K1-K4 each):
    1, one frame with ``sequence_learning=False``; 2, the same model on
    three scans concatenated into one cloud of 3 x 131,072 padded points
    (the accumulated-cloud semantics); 3, gru-gru-gru-gru over 3 frames.
    Each also card vs CPU on the same cut of the reduced sequence."""
    def first(d):
        return tuple(a[:1] for a in d)

    def concat3(d):
        return tuple(a[:3].reshape((1, -1) + a.shape[2:]) for a in d)

    def first3(d):
        return tuple(a[:3] for a in d)

    single = model_config(sequence_learning=False, frames_per_seq=1,
                          rnn_modules=("gru",) * 4)
    # (config, frames of a sequence, points per frame over the sequence's)
    cases = {
        "config1_single_frame": (single, first, 1),
        "config2_accumulated_clouds": (single, concat3, 3),
        "config3_gru_frames3": (
            model_config(frames_per_seq=3, rnn_modules=("gru",) * 4),
            first3, 1),
    }
    small = lidar(SMALL_RT["max_points"])
    res = {}
    for name, (cfg, frames, scale) in cases.items():
        rt_kw = dict(FLAGSHIP_RT, max_points=scale * FLAGSHIP_RT["max_points"])
        model, fwd, rt = make_forward(rt_kw, dev, cfg=cfg)
        _, res[name] = config_forward(frames(data), fwd, rt, FORWARD_KERNELS)
        del model, fwd
        torch.cuda.empty_cache()
        res[name]["card_vs_cpu"] = card_vs_cpu(
            dev, cfg, dict(SMALL_RT, max_points=scale * SMALL_RT["max_points"]),
            data=frames(small))
    return res


def per_frame_f32(dev, data, state_dict):
    """Phase 14: the flagship in float32 on the non-batched route with
    ``reference_bary_quirk`` (the faithful evaluation of a reference-trained
    checkpoint): per frame, the pointnet's float32 scatter max and argmax
    over the frame's rows (K1-K3 in the lattice build, K2 in every
    coarsen; no K4).  The flagship's weights; its log-probabilities beside
    the bf16 flagship's (reported, not gated); card vs CPU."""
    _, flagship, _ = make_forward(FLAGSHIP_RT, dev, state_dict)
    logp_bf16 = flagship(*data)[0]
    del flagship
    cfg = model_config(compute_dtype="float32", reference_bary_quirk=True)
    rt_kw = dict(FLAGSHIP_RT, batched_pointnet=False)
    model, fwd, rt = make_forward(rt_kw, dev, state_dict, cfg)
    logp, res = config_forward(data, fwd, rt, FORWARD_KERNELS[:3])
    del model, fwd
    torch.cuda.empty_cache()
    res["vs_bf16_flagship"] = logp_stats(logp, logp_bf16, data[2][-1])
    small = dict(SMALL_RT, batched_pointnet=False)
    res["card_vs_cpu"] = card_vs_cpu(dev, cfg, small, F32_LOGP_ATOL)
    res["pointnet_card_vs_cpu"] = per_frame_pointnet_card_vs_cpu(dev, cfg,
                                                                 small)
    return res


def per_frame_pointnet_card_vs_cpu(dev, cfg, rt_kw):
    """The last frame's float32 per-frame pointnet on the card and on the
    CPU, on each device's own sequence lattice: the maxima within
    ``F32_MAX_ATOL``, and the (vertex, channel) entries whose barycentric
    weight differs (another winning row), counted."""
    import copy

    from temporal_latticenet_tpu_torch.config import RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice

    rt = RuntimeConfig(**rt_kw)
    pn = LNNSeq(cfg, rt, device="cpu", seed=0).point_net_seq
    data = lidar(rt_kw["max_points"])
    out = {}
    for d, mod in (("cpu", pn), (dev, copy.deepcopy(pn).to(dev))):
        pos, val, mask = (torch.as_tensor(a, device=d) for a in data)
        t = pos.shape[0] - 1
        with torch.no_grad():
            lat, _, _ = sequence_lattice(cfg, rt, pos, val, mask)
            dist = lat.distribute_out().frame(t)
            rows = val[t].repeat_interleave(4, dim=0) * dist.row_valid[:, None]
            out[d] = mod.reduce_frame(dist, rows, rt.capacities(2)[0],
                                      lat.levels[0].counts[t],
                                      lat.nr_points[t]).cpu()
    a, b = out["cpu"], out[dev]
    c = a.shape[1] // 2
    mx_diff = float((a[:, :c] - b[:, :c]).abs().max())
    differ = int((a[:, c:] != b[:, c:]).sum())
    if mx_diff > F32_MAX_ATOL:
        raise AssertionError(f"float32 pointnet maxima differ card vs CPU: "
                             f"{mx_diff}")
    return dict(max_abs_diff=mx_diff, max_atol=F32_MAX_ATOL,
                bary_entries_differ=differ,
                entries=int(a[:, c:].count_nonzero()))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's result to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from temporal_latticenet_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    report, failed = {}, []

    def phase(name, fn):
        t0 = time.perf_counter()
        log(f"== {name}")
        try:
            out = fn()
            report[name] = out
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
            return out
        except Exception as e:  # a phase's failure fails the run, at the end
            failed.append(name)
            report[name] = {"error": f"{type(e).__name__}: {e}"}
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            return None

    dline = phase("device", device_line)
    if dline:
        log(dline)
    built = phase("build", _cuda.build)
    if built:
        log(f"[build] {built['seconds']:.2f} s for {len(built['built'])} "
            f"libraries")
    data = lidar(FLAGSHIP_RT["max_points"])
    kernels = None
    if built:
        kernels = phase("kernels", lambda: check_kernels(
            dev, kernel_inputs(dev, data)))
        model, fwd_fn, rt = make_forward(FLAGSHIP_RT, dev)
        fwd = phase("forward", lambda: flagship_forward(dev, data, fwd_fn,
                                                        rt))
        if fwd:
            log(f"[forward] {fwd['seconds_per_seq']:.4f} s/seq, "
                f"{fwd['points_per_s']:.0f} points/s on {dline}; "
                f"launches {fwd['launches']}")
        prof = phase("profile", lambda: profile_forward(dev, data, model,
                                                        fwd_fn, rt))
        if prof:
            log(f"[profile] {json.dumps(prof['stages'])}; "
                f"{prof['device_ms_per_seq']:.2f} device ms and "
                f"{prof['device_launches_per_seq']:.0f} launches per seq, "
                f"device busy {prof['device_busy_share']:.3f}; "
                f"hand-written {json.dumps(prof['hand_written'])}")
        phase("card_vs_cpu", lambda: card_vs_cpu(dev))
        packed = phase("forward_packed", lambda: packed_forward(
            dev, data, model, fwd_fn, rt))
        if packed:
            log(f"[forward_packed] reduced tensor bit-equal, max |d logp| "
                f"{packed['logp_max_abs_diff']}; launches "
                f"{packed['launches']}")
        weights = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
        del model, fwd_fn
        torch.cuda.empty_cache()
        train = phase("train", lambda: train_flagship(
            dev, (fwd or {}).get("launches") or {}))
        if train:
            log(f"[train] {train['seconds_per_step']:.4f} s/step (quartiles "
                f"{train['quartiles']}) on {dline}; peak "
                f"{train['peak_mem_gb']:.2f} GB; losses {train['losses']}; "
                f"launches {train['launches']}; "
                f"{train['device_ms_per_step']:.2f} device ms per step, "
                f"device busy {train['device_busy_share']:.3f}; "
                f"hand-written {json.dumps(train['hand_written'])}")
        phase("train_card_vs_cpu", lambda: train_card_vs_cpu(dev))
        torch.cuda.empty_cache()
        stream = phase("streaming", lambda: streaming_flagship(dev, weights))
        if stream:
            for name in ("plain", "incremental"):
                r = stream[name]
                log(f"[streaming] {name}: non-final frames "
                    f"{r['non_final_ms']:.2f} ms (quartiles "
                    f"{r['non_final_quartiles_ms']}), "
                    f"final {r['final_ms']:.2f} ms (quartiles "
                    f"{r['final_quartiles_ms']}) on {dline}; "
                    f"{r['device_ms_per_frame']:.2f} device ms and "
                    f"{r['device_launches_per_frame']:.0f} launches per "
                    f"frame, device busy {r['device_busy_share']:.3f}; "
                    f"launches per frame {r['launches_per_frame']}; host "
                    f"syncs {r['host_syncs_per_sequence']}; peak "
                    f"{r['peak_mem_gb']:.2f} GB; growth "
                    f"{r['growth_per_frame']}")
        phase("streaming_card_vs_cpu", lambda: streaming_card_vs_cpu(dev))
        torch.cuda.empty_cache()
        kinds = phase("all_kinds", lambda: all_kinds(dev, data))
        if kinds:
            log(f"[all_kinds] {kinds['seconds_per_seq']:.4f} s/seq (quartiles "
                f"{kinds['quartiles']}), {kinds['device_ms_per_seq']:.2f} "
                f"device ms and {kinds['device_launches_per_seq']:.0f} "
                f"launches per seq on {dline}; launches {kinds['launches']}; "
                f"step {kinds['train']['seconds_per_step']:.4f} s, "
                f"{kinds['train']['device_ms_per_step']:.2f} device ms, peak "
                f"{kinds['train']['peak_mem_gb']:.2f} GB; card vs CPU "
                f"{json.dumps(kinds['card_vs_cpu'])}")
        base = phase("baseline_configs", lambda: baseline_configs(dev, data))
        for name, r in (base or {}).items():
            log(f"[baseline_configs] {name}: {r['seconds_per_seq']:.4f} s "
                f"(quartiles {r['quartiles']}), {r['device_ms_per_seq']:.2f} "
                f"device ms, {r['device_launches_per_seq']:.0f} launches per "
                f"forward on {dline}; occupancy {r['occupancy']}; launches "
                f"{r['launches']}; card vs CPU {json.dumps(r['card_vs_cpu'])}")
        f32 = phase("per_frame_f32", lambda: per_frame_f32(dev, data,
                                                           weights))
        if f32:
            log(f"[per_frame_f32] {f32['seconds_per_seq']:.4f} s/seq "
                f"(quartiles {f32['quartiles']}), "
                f"{f32['device_ms_per_seq']:.2f} device ms and "
                f"{f32['device_launches_per_seq']:.0f} launches per seq on "
                f"{dline}; launches {f32['launches']}; vs the bf16 flagship "
                f"{json.dumps(f32['vs_bf16_flagship'])}; card vs CPU "
                f"{json.dumps(f32['card_vs_cpu'])}")

    # launches: the training step (this slice's path, on the packed route);
    # the forwards' counts beside them
    launches = (report.get("train") or {}).get("launches") or {}
    fwd_launches = (report.get("forward") or {}).get("launches") or {}
    packed_launches = (report.get("forward_packed") or {}).get("launches") \
        or {}
    stream = report.get("streaming") or {}
    on_path = (report.get("profile") or {}).get("hand_written") or {}
    on_step = (report.get("train") or {}).get("hand_written") or {}
    line = []
    for name, meta in KERNELS.items():
        k = (kernels or {}).get(name) or {}
        line.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches.get(name, 0),
            max_abs_err=k.get("max_abs_err"), ms=k.get("ms"),
            plain_ms=k.get("plain_ms"), bound_ms=k.get("bound_ms"),
            bound_by=k.get("bound_by"), library_ms=k.get("library_ms"),
            wall_ms=k.get("wall_ms"), case=k.get("case"),
            launches_forward=fwd_launches.get(name, 0),
            launches_forward_packed=packed_launches.get(name, 0),
            launches_streaming=((stream.get("plain") or {}).get("launches")
                                or {}).get(name, 0),
            launches_streaming_incremental=(
                (stream.get("incremental") or {}).get("launches")
                or {}).get(name, 0),
            main_path_device_ms_per_seq=(on_path.get(name) or {}).get(
                "device_ms_per_seq"),
            main_path_device_ms_per_step=(on_step.get(name) or {}).get(
                "device_ms_per_step"),
            launches_all_kinds=((report.get("all_kinds") or {}).get(
                "launches") or {}).get(name, 0),
            launches_all_kinds_step=((report.get("all_kinds") or {}).get(
                "train") or {}).get("launches", {}).get(name, 0),
            launches_baseline_configs={
                k: (v.get("launches") or {}).get(name, 0)
                for k, v in (report.get("baseline_configs") or {}).items()},
            launches_per_frame_f32=((report.get("per_frame_f32") or {}).get(
                "launches") or {}).get(name, 0),
            cases=k.get("cases")))
    report["device_line"] = dline
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": line}))
    log(dline)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
