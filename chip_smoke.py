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
   the finefy slices' backward shapes, on the trimmed final links of
   phase 4's geometry and on the untrimmed links of the shipped train cfg
   (phase 15's), then at the look-back's edge cases
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
   package, on both routes of the pointnet max: the default one (K4, the
   route the loop and the accuracy experiments train on) and the packed
   one (K5 and K4);
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
15. the training and evaluation loop from ``seq_config/lnn_train_semantic_kitti.cfg``
    and ``lnn_eval_semantic_kitti.cfg`` (copies with only the paths and
    the read counts overridden: full width, bf16, 131,072 points, no
    trims, augmentation on) on an on-disk SemanticKITTI tree of
    LiDAR-like scans (sequences 00 and 08, ``LOOP_SCANS`` each, written
    under ``build/``): ``run_training`` for one epoch's train phase and
    its valid phase, then ``run_eval`` of the valid split from the saved
    epoch checkpoint, writing devkit predictions.  It reports the
    loader's milliseconds per window, the loop's seconds per step (median
    and quartiles) beside the bare training step's on a window loaded in
    advance, the valid and eval seconds per sequence, the host syncs of
    one loop step, peak memory, and the K1-K4 launches and device time of
    one loop step under ``torch.profiler``; it fails unless the losses are
    finite, the reloaded checkpoint gives the trained model's
    log-probabilities bit for bit, a resume from the epoch checkpoint
    gives the next two steps' losses of continuing bit for bit (and a
    resume with a fresh optimizer another second loss; one with AdamW's
    ``max_exp_avg_sq`` dropped is recorded), every scan has its devkit
    ``.label`` and the submission check passes, and a reference-schema
    ``.pt`` of the weights loads strictly;
16. the experiment ablations (each of ``slice_no_deform``,
    ``pointnet_no_elevate``, ``pointnet_no_local_mean``,
    ``pointnet_no_elevate_no_local_mean``, ``splat`` and
    ``attention_pool``) at phase 4's geometry, bf16, the four that change
    the pointnet's reduced width behind the early fusion "none": phase
    12's forward measurements (``CONFIG_ITERS`` timed forwards, device time,
    launches, peak memory), with K1 and K2 launched, K3 launched except
    without the local mean, K4 and K5 never (an experiment runs the
    per-frame pointnet), and card vs CPU at the reduced geometry;
    ``pointnet_no_local_mean`` and ``attention_pool`` also through both
    streaming paths (phase 10's measurements), each final frame against
    the offline forward; one warm and ``ABLATION_STEPS`` timed training
    steps of ``attention_pool`` and of the flagship with
    ``dropout_last_layer`` 0.2, finite losses, every step's dropped share
    within ``DROPPED_ATOL`` of the rate;
17. data parallelism on the one card: ``DP_RANKS`` ranks spawned as child
    processes (start method spawn) share ``cuda:0`` over ``gloo`` (NCCL
    refuses two ranks on one card), each with one sequence of phase 4's
    geometry (seeds 0 and 1, flagship, default K4 route, full remat): a
    ``grad_step`` and one warm and ``DP_TIMED_STEPS`` timed training
    steps, against this process's B = 2 step on the same two sequences:
    losses within 1e-6 relative, every reduced gradient within 1e-6 of its
    parameter's largest magnitude, the weights after the steps equal
    across the ranks and within 5e-5 of the one process's.  It reports
    seconds per step (ranks, B = 2, phase 8's B = 1), each rank's peak
    memory, the gradient all-reduce's milliseconds and the K1-K4 launches
    of one rank-step; then ``DP_STREAMS`` streams of phase 10's geometry
    over the ranks (plain and incremental), each gathered final frame
    against the one process's batched streams within phase 10's
    tolerance, with the milliseconds per frame.  Ranks that share a card
    measure correctness, not scaling.  A rank that fails or hangs
    terminates both and fails the phase (``DP_TIMEOUT``);
18. the utilities: ``autotune_capacities`` over two sequences of phase
    4's data (its level counts equal the flagship build's; K1-K3
    launched), ``profiling.trace`` around one flagship forward (the trace holds the
    "distribute" and "pointnet" spans and K1-K4), and ``visualize_cli`` on
    one sequence of the reduced geometry from the shipped eval cfg
    without ``--render`` (one ``.npz`` per frame after the first, weights
    finite, neighbors inside the capacity), each with its seconds;
19. the accuracy experiments (``temporal_latticenet_tpu_torch/
    experiments/``) at the small scale (32,768-point scans): the occupancy
    probe over 2 moving worlds of 8 scans (every level's worst union count
    under its capacity); ``train_lidar`` (2 worlds of 6 scans and a
    held-out one, full width, written under ``build/``) for 2 epochs in
    each of the temporal, static and accumulated variants, the temporal
    one resumed for a third epoch from its newest epoch checkpoint, and
    the generalization run's flags (no moving actors, augmentation,
    selective remat); then ``overfit_lidar --smoke`` for 4 epochs, its
    valid ``.label`` files scored again by ``evaluate_semantics``.  Each
    run: finite losses, K1-K4 launched in every training step and K5 in
    none, the epochs trained (the resume only the missing one), one
    checkpoint an epoch, the JAX scripts' results keys with IoUs in
    [0, 1]; the overfit's last epoch's mean loss below its first's and
    ``evaluate_semantics``'s mIoU equal to ``run_eval``'s.  It reports each
    run's seconds a step (median and quartiles, host clock), the loader's
    seconds a window, peak memory, launches a step, each epoch's mean loss
    and the train and valid mIoU;
20. the three benchmark drivers, each run as a user runs it
    (``python -m temporal_latticenet_tpu_torch.<driver>`` in a child
    process under ``build/``, ``TLN_BENCH_BUDGET_S`` = ``BENCH_BUDGET_S``):
    ``bench --details``; ``train_bench`` with ``--remat selective`` on the
    default route (K4), the same under ``TLN_MAXSCAN_PACKED=1`` (K5 and
    K4), ``--remat full`` and ``--remat none``; ``bench_streaming
    --streams 4``.  Each must exit 0 with a last line of its JAX script's
    keys and metric, a positive value, no saturated table, no trim
    overflow and no vertex overflow; ``bench`` and the default-route steps
    launch K1-K4, the packed one K5, the default ones no K5; peak memory
    inside the card's.  It reports each line, ``bench``'s repetitions with
    their spread and host syncs, and each step's launches and memory;
21. one JSON line with the kernels, the device line, and the result line
    ``{"ok": true, "device": {...}}`` last.

Phase 8 also reports the deform slice's gather backward
(``indexing_backward_kernel``, once a 21.48 ms launch): no single launch of
it may take over 1 ms.

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
PROFILE_TRIES = 5      # tries of a profiler window that lost device events
PROFILE_RETRY_S = 0.5  # pause before the second try, doubled for each next
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
# phases 12-14: the other model configurations at the bench geometry
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
# phase 15: the loop from the shipped cfgs on an on-disk tree
ROOT = os.path.dirname(os.path.abspath(__file__))
LOOP_DIR = os.path.join(ROOT, "build", "loop_smoke")
LOOP_SCANS = 12        # scans of sequences 00 (train) and 08 (valid)
LOOP_TIMED = range(1, 9)   # loop steps timed (after the first, warm one)
LOOP_PROFILE_STEP = 9  # the loop step under torch.profiler
LOOP_SYNC_STEP = 10    # the loop step whose host syncs are counted
BARE_STEPS = 5         # timed bare training steps after a warm one
# the shipped cfgs' data path, output paths and read count
LOOP_EDITS = {
    "train": (('"/workspace/Data/SemanticKitti/dataset"', '"{data}"'),
              ('checkpoint_path: "./checkpoints/"',
               'checkpoint_path: "{ckpt}"'),
              ("nr_clouds_to_read: -1",
               "nr_clouds_to_read: {n}\n    measure_sequence_lengths: true")),
    "eval": (('"/workspace/Data/SemanticKitti/dataset"', '"{data}"'),
             ('checkpoint_path: "./pretrained_models"',
              'checkpoint_path: "{ckpt}"'),
             ('load_checkpoint_model: ""', 'load_checkpoint_model: "{model}"'),
             ("do_write_predictions: false", "do_write_predictions: true"),
             ('"./predictions/gru_gru_aflow_gru"', '"{preds}"'),
             ("nr_clouds_to_read: -1",
              "nr_clouds_to_read: -1\n    measure_sequence_lengths: true")),
}

# phase 16: the experiment ablations (the JAX package's
# config.VALID_EXPERIMENTS but "none"), at phase 4's geometry
EXPERIMENTS = ("slice_no_deform", "pointnet_no_elevate",
               "pointnet_no_local_mean", "pointnet_no_elevate_no_local_mean",
               "splat", "attention_pool")
NO_LOCAL_MEAN = ("pointnet_no_local_mean",
                 "pointnet_no_elevate_no_local_mean")
STREAMED_EXPERIMENTS = ("pointnet_no_local_mean", "attention_pool")
# the kernels every experiment's forward launches (K3 also, with the local
# mean; never K4 or K5: an experiment runs the per-frame pointnet)
ABLATION_KERNELS = ("fused_simplex_pack", "sorted_segment_scan")
ABLATION_STEPS = 3     # timed training steps after the warm one
DROPOUT = 0.2
# the dropped share of the 131,072 x 192 slice features lies within 4e-4
# of the rate at 5 standard deviations; a mask of another rate misses this
DROPPED_ATOL = 0.02


# phase 17: data parallelism on the one card (ranks that share it, gloo)
DP_RANKS = 2
DP_TIMED_STEPS = 3     # timed steps after the warm one
DP_STREAMS = 4         # streams over the ranks, DP_STREAMS / DP_RANKS each
DP_LOSS_RTOL = 1e-6
DP_GRAD_REL = 1e-6     # of each parameter's largest gradient magnitude
DP_WEIGHT_ATOL = 5e-5  # the JAX package's own bound (tests/test_train.py)
DP_TIMEOUT = 600.0     # seconds for both ranks, start-up included
DP_DIR = os.path.join(ROOT, "build", "dp_smoke")
# phase 18: the utilities
UTIL_DIR = os.path.join(ROOT, "build", "utils_smoke")
AUTOTUNE_KERNELS = ("fused_simplex_pack", "sorted_segment_scan",
                    "seg_sum_tails")
# phase 19: the accuracy experiments at the small scale
EXP_DIR = os.path.join(ROOT, "build", "experiments_smoke")
EXP_SIZE = ["--scale", "small", "--worlds", "2", "--scans", "6"]
EXP_OCCUPANCY = ["--scale", "small", "--moving", "1", "--worlds", "2",
                 "--scans", "8", "--stride", "1"]
EXP_EPOCHS = 2
OVERFIT_EPOCHS = 4
LOADER_WINDOWS = 6     # windows timed through the loader alone
# the keys of the JAX package's results JSON (scripts/train_lidar.py:334-357,
# scripts/overfit_lidar.py:219-231)
TRAIN_LIDAR_KEYS = ("variant", "moving", "worlds", "scans",
                    "train_windows_per_epoch", "epochs", "scale", "scope",
                    "train_wall_s", "checkpoint", "miou_train", "iou_train",
                    "miou_valid", "iou_valid")
OVERFIT_KEYS = ("loader_s_per_seq", "train_wall_s", "epochs", "capacity",
                "miou_train", "miou_valid")

# phase 20: the benchmark drivers as a user runs them
BENCH_DIR = os.path.join(ROOT, "build", "bench_smoke")
BENCH_BUDGET_S = 240       # TLN_BENCH_BUDGET_S of the bench run
BENCH_TIMEOUT = 300        # seconds for one driver's process
# the JAX scripts' result keys (bench.py:310-316, scripts/train_bench.py:
# 123-137, scripts/bench_streaming.py:169-188)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")
TRAIN_BENCH_KEYS = ("metric", "value", "unit", "seconds_per_step",
                    "seconds_per_step_synced", "timing_protocol",
                    "compile_seconds", "remat", "trim_capacity",
                    "final_capacity", "vertex_overflow")
STREAMING_KEYS = ("metric", "trimmed_frame_ms", "final_frame_ms",
                  "incremental_trimmed_frame_ms",
                  "incremental_final_frame_ms", "points_per_frame",
                  "compile_seconds", "incremental_compile_seconds", "note")
STREAMS_KEYS = ("streams", "mesh_devices", "streams_trimmed_frame_ms",
                "streams_final_frame_ms", "streams_compile_seconds")
BENCH_STREAMS = 4
# (name, driver module, flags, TLN_MAXSCAN_PACKED)
BENCH_RUNS = (
    ("bench", "bench", ["--details"], False),
    ("train_bench_selective", "train_bench", ["--remat", "selective"], False),
    ("train_bench_selective_packed", "train_bench",
     ["--remat", "selective"], True),
    ("train_bench_full", "train_bench", ["--remat", "full"], False),
    ("train_bench_none", "train_bench", ["--remat", "none"], False),
    ("bench_streaming", "bench_streaming",
     ["--streams", str(BENCH_STREAMS)], False),
)

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


def device_side(prof):
    """The device-side events of a finished profile (kernels, copies,
    fills), without the ``ProfilerStep`` span of its schedule."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def lost_launches(events, launched: dict) -> dict:
    """{kernel: (seen, launched)} for each of K1-K5 whose kernels in
    ``events`` number fewer than its ``launched`` count."""
    seen = {}
    for e in events:
        k = hand_written(e.name)
        seen[k] = seen.get(k, 0) + 1
    return {k: (seen.get(k, 0), n) for k, n in launched.items()
            if seen.get(k, 0) < n}


# windows that lost device events and were taken again: (seen, launched)
PROFILER_RETRIES: list = []


def profile_retry_pause(tries: int) -> None:
    """Sleep before the next try of a profiler window that lost events: a
    spell of losses may outlast one window, and tries taken back to back
    would all fall into it."""
    time.sleep(PROFILE_RETRY_S * 2 ** (tries - 1))


def device_events(fn, calls: int):
    """The device-side events (kernels, copies, fills) of ``calls`` calls of
    ``fn`` under ``profiling.window``, and the wall microseconds of the
    window.  Now and then a session records no device events, or fewer
    kernels of K1-K5 than were launched in it: such a window is taken
    again, after a growing pause, up to ``PROFILE_TRIES`` times in all, and
    then fails."""
    from temporal_latticenet_tpu_torch.ops import _cuda
    from temporal_latticenet_tpu_torch.utils import profiling

    for tries in range(1, PROFILE_TRIES + 1):
        before = _cuda.launch_counts()
        with profiling.window() as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = {k: n - before[k]
                    for k, n in _cuda.launch_counts().items()}
        events = device_side(prof)
        lost = lost_launches(events, launched)
        if events and not lost:
            return events, wall_us
        PROFILER_RETRIES.append(lost or "no device events")
        if tries < PROFILE_TRIES:
            profile_retry_pause(tries)
    raise RuntimeError(f"torch.profiler lost device events in "
                       f"{PROFILE_TRIES} windows: {PROFILER_RETRIES[-1]}")


def device_ms(fn, iters: int):
    """Device time of one call: the summed durations of the device work it
    launches, mean over ``iters`` calls after one warm-up call; the device
    operations (kernels, copies, memsets) of one call; the events."""
    fn()
    torch.cuda.synchronize()
    events, _ = device_events(fn, iters)
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

def shipped_train_configs():
    """The model and runtime configurations of the shipped train cfg, which
    phase 15's loop runs (capacities 49152/24576/12288, no trims)."""
    from temporal_latticenet_tpu_torch.config import (
        cfgParser, model_config_from_cfg, nr_classes_from_cfg,
        runtime_config_from_cfg)
    parser = cfgParser(os.path.join(ROOT, "seq_config",
                                    "lnn_train_semantic_kitti.cfg"))
    return (model_config_from_cfg(parser, nr_classes_from_cfg(parser)),
            runtime_config_from_cfg(parser))


def kernel_inputs(dev, data):
    """Real main-path operands: the full-width lattice built on the card as
    the forward builds it, the final frame's trimmed links, and the links
    of the same data under the shipped train cfg (untrimmed: the loop's)."""
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.ops import permutohedral as pm
    from temporal_latticenet_tpu_torch.ops import seq_lattice as sl
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice

    rt = RuntimeConfig(**FLAGSHIP_RT)
    pos, val, mask = (torch.as_tensor(a, device=dev) for a in data)
    lat, _, final_caps = sequence_lattice(ModelConfig(), rt, pos, val, mask)
    final = sl.trim_sequence_lattice(lat, final_caps)
    cfg_s, rt_s = shipped_train_configs()
    loop_lat, trims, finals = sequence_lattice(cfg_s, rt_s, pos, val, mask)
    if trims is not None or finals is not None:
        raise AssertionError("the shipped train cfg now trims its lattice")
    t, p = mask.shape
    y = pm.scale_positions(pos.reshape(t * p, 3), rt.sigma).contiguous()
    return dict(y=y, mask=mask.reshape(-1).contiguous(), spn=lat.sorted_pn,
                links=final.links, loop_links=loop_lat.links, p=p)


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
    # backward (128-channel cotangents over link 1, then link 0); on the
    # flagship geometry's trimmed links, then on the shipped train cfg's
    # untrimmed ones, which the loop's steps (phase 15) run
    link0, link1 = inp["links"]
    for geometry, (l0, l1) in (("", inp["links"]),
                               ("shipped cfg, no trims: ",
                                inp["loop_links"])):
        for use, link, c in (("coarsen splat", l0, 64),
                             ("coarsen splat / slice backward", l1, 128),
                             ("slice backward", l0, 128)):
            dst = link.sorted_dst
            rows = torch.randn(dst.shape[0], c, generator=g, device=dev)
            m = dst.shape[0]

            def k2():
                return ss.sorted_segment_scan(dst, rows, "sum")
            case("sorted_segment_scan",
                 f"{geometry}{use}: sum float32 Q={m} C={c}", k2,
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
    sequence), log-probabilities within ``atol``; the lattice as ``cfg``
    builds it (without the local mean under the no-local-mean
    experiments)."""
    from temporal_latticenet_tpu_torch.models.pointnet import \
        subtract_local_mean
    from temporal_latticenet_tpu_torch.ops import seq_lattice as sl

    if data is None:
        data = lidar(rt_kw["max_points"])
    cpu_model, cpu_fwd, rt = make_forward(rt_kw, "cpu", cfg=cfg)
    _, dev_fwd, _ = make_forward(rt_kw, dev, cpu_model.state_dict(), cfg)
    mean = subtract_local_mean(cpu_model.cfg)
    lats = [sl.build_sequence_lattice(
        torch.as_tensor(data[0], device=d), torch.as_tensor(data[2], device=d),
        rt.sigma, rt.capacities(2), 2, subtract_local_mean=mean,
        pn_values=torch.as_tensor(data[1], device=d) if mean else None,
        want_row_rel=True)
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

def make_trainer(rt_kw, device, state_dict=None, cfg=None, mesh=None):
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
    from temporal_latticenet_tpu_torch.train import engine

    cfg = cfg or ModelConfig()
    rt = RuntimeConfig(**rt_kw, remat_mode="full")
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3, seed=0,
                                             device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if mesh is not None:
        pmesh.replicate(mesh, model)
    train_step, _ = engine.make_train_step(model, cfg, rt, mesh=mesh)
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


def grad_agreement(loss_c, g_c, loss_d, g_d) -> dict:
    """``grad_step`` on the CPU (``loss_c``, ``g_c``) against the card's:
    |d loss|, the smallest per-parameter gradient cosine and its parameter,
    the global norms, the cosines under 0.999, and whether all three hold
    phase 9's tolerances."""
    d_loss = abs(float(loss_c) - float(loss_d))
    cos = {k: _cosine(g_c[k], g_d[k].cpu()) for k in g_c}
    worst = min(cos, key=cos.get)
    n_c = math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_c.values()))
    n_d = math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_d.values()))
    return dict(loss_cpu=float(loss_c), loss_card=float(loss_d),
                loss_abs_diff=d_loss, min_grad_cosine=cos[worst],
                min_cosine_param=worst, grad_norm_cpu=n_c, grad_norm_card=n_d,
                cosines_below_0999={k: v for k, v in cos.items()
                                    if v < 0.999},
                within_tolerance=(d_loss <= LOSS_ATOL
                                  and cos[worst] >= GRAD_COSINE
                                  and abs(n_d - n_c) <= NORM_RTOL * n_c))


def train_card_vs_cpu(dev):
    """Phase 9: ``grad_step`` on the card against the CPU's (the kernels'
    plain versions) from the same weights and batch, on both routes of the
    pointnet max: the default one-scan route (K4, the loop's and the
    experiments'), then the packed two-level route (K5 and K4).  Each
    route is held to the same tolerances, and its card step must have
    launched its route's kernels."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    cpu_model, _, cpu_step = make_trainer(SMALL_RT, "cpu")
    _, _, dev_step = make_trainer(SMALL_RT, dev, cpu_model.state_dict())
    p = SMALL_RT["max_points"]
    out, errors = {}, []
    for route, ctx in (("k4", contextlib.nullcontext), ("packed",
                                                        packed_route)):
        with ctx():
            loss_c, g_c = cpu_step.grad_step(train_batch(p, "cpu"))
            _cuda.reset_launch_counts()
            loss_d, g_d = dev_step.grad_step(train_batch(p, dev))
            launches = _cuda.launch_counts()
        r = grad_agreement(loss_c, g_c, loss_d, g_d)
        if not r["within_tolerance"]:
            errors.append(f"{route}: gradients differ card vs CPU: loss "
                          f"{r['loss_abs_diff']}, cosine "
                          f"{r['min_grad_cosine']} ({r['min_cosine_param']}),"
                          f" norms {r['grad_norm_card']} vs "
                          f"{r['grad_norm_cpu']}")
        k5 = launches["sorted_segment_max_window"]
        if not launches["sorted_segment_max_u32"] or bool(k5) != (
                route == "packed"):
            errors.append(f"{route}: launches {launches}")
        out[route] = dict(r, launches=launches)
    if errors:
        raise AssertionError("; ".join(errors))
    return dict(points=p, routes=out,
                tolerance=dict(loss=LOSS_ATOL, cosine=GRAD_COSINE,
                               norm_rtol=NORM_RTOL))


# ---------------------------------------------------------------------------
# phases 10 and 11: streaming serving
# ---------------------------------------------------------------------------

def stream_fns(model, rt_kw, incremental: bool, max_new: int = MAX_NEW):
    from temporal_latticenet_tpu_torch.config import RuntimeConfig
    from temporal_latticenet_tpu_torch.train import engine

    cfg, rt = model.cfg, RuntimeConfig(**rt_kw)
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
    """Calls inside ``fn`` that made the host wait for the device, counted
    by the innermost line of this repository on the stack that made them
    (``utils/profiling.host_syncs``)."""
    from temporal_latticenet_tpu_torch.utils.profiling import \
        host_syncs as counting_host_syncs

    with counting_host_syncs() as where:
        fn()
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
    """Phase 10 for one streaming path at full width (also phase 16's, for
    its experiments: the path runs ``model.cfg``)."""
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
# phases 12-14: the other model configurations
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
# phase 15: the training and evaluation loop from the shipped cfgs
# ---------------------------------------------------------------------------

def write_kitti_tree(root: str, scans: int) -> None:
    """Sequences 00 and 08 of a SemanticKITTI tree: ``scans`` LiDAR-like
    scans each (131,072 rays, about 120k returns) in their own sensor
    frames, raw labels through the 26-class inverse map, identity calib
    and poses of the sensor's drive."""
    from temporal_latticenet_tpu_torch.data.kitti_meta import build_inverse_lut
    from temporal_latticenet_tpu_torch.data.lidar_like import lidar_sequence

    inv = build_inverse_lut(True)
    eye = "1 0 0 0 0 1 0 0 0 0 1 0"
    for seed, seq in enumerate(("00", "08")):
        pos, val, lab, mask = lidar_sequence(np.random.default_rng(seed),
                                             frames=scans, max_points=131072)
        d = os.path.join(root, "sequences", seq)
        os.makedirs(os.path.join(d, "velodyne"))
        os.makedirs(os.path.join(d, "labels"))
        with open(os.path.join(d, "calib.txt"), "w") as f:
            f.write(f"P0: {eye}\nTr: {eye}\n")
        with open(os.path.join(d, "poses.txt"), "w") as f:
            for t in range(scans):
                # lidar_sequence's sensor drive, in frame-0 coordinates
                sx, sy = float(t), 0.02 * t
                sensor = np.array([sx, sy, 0.0], np.float32)
                f.write(f"1 0 0 {sx!r} 0 1 0 {sy!r} 0 0 1 0\n")
                m = mask[t]
                np.concatenate([pos[t][m] - sensor, val[t][m]], 1).astype(
                    np.float32).tofile(os.path.join(d, "velodyne",
                                                    f"{t:06d}.bin"))
                inv[lab[t][m]].astype(np.uint32).tofile(
                    os.path.join(d, "labels", f"{t:06d}.label"))


def loop_cfg(kind: str, out: str, **fields) -> str:
    """A copy of the shipped train or eval cfg with ``LOOP_EDITS``."""
    src = os.path.join(ROOT, "seq_config",
                       f"lnn_{kind}_semantic_kitti.cfg")
    text = open(src).read()
    for a, b in LOOP_EDITS[kind]:
        if a not in text:
            raise AssertionError(f"{src} no longer holds {a!r}")
        text = text.replace(a, b.format(**fields))
    path = os.path.join(out, f"{kind}.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path


class LoopProbe:
    """Stands in for the loop's ``StateCallback`` (a subclass of it): the
    host clock, loss and launch counts at each sequence, the mean IoU at
    each epoch end; a ``torch.profiler`` window around train step
    ``LOOP_PROFILE_STEP`` and the host syncs of step ``LOOP_SYNC_STEP``.
    Each callback runs after the step's ``float(loss)``, so the device
    has finished the step; the time from one callback to the next is one
    whole loop step (the loader's wait, the batch's copy, the step, the
    host reads and the IoU bookkeeping)."""

    def __init__(self, loop_mod):
        from temporal_latticenet_tpu_torch.ops import _cuda
        from temporal_latticenet_tpu_torch.utils import profiling
        self.loop_mod, self.base = loop_mod, loop_mod.StateCallback
        self.seqs, self.miou, self.events, self.syncs = [], {}, None, None
        self.prof, self.t_prof = None, 0.0
        self.window = contextlib.ExitStack()
        probe, stack = self, contextlib.ExitStack()

        class Probe(self.base):
            def after_forward_pass(self, *, phase=None, **kw):
                t = time.perf_counter()
                i = len(probe.steps(phase.name))
                train = phase.grad
                # the windows close at this callback's entry and open at
                # its exit: they hold the loop's work and none of the probe's
                if train and i == LOOP_PROFILE_STEP:
                    probe.window.close()
                    wall = (t - probe.t_prof) * 1e6
                    probe.events = (device_side(probe.prof), wall)
                if train and i == LOOP_SYNC_STEP:
                    stack.close()
                probe.seqs.append((phase.name, t, float(kw["loss"]),
                                   _cuda.launch_counts()))
                super().after_forward_pass(phase=phase, **kw)
                if train and i == LOOP_PROFILE_STEP - 1:
                    probe.prof = probe.window.enter_context(
                        profiling.window())
                    probe.t_prof = time.perf_counter()
                if train and i == LOOP_SYNC_STEP - 1:
                    probe.syncs = stack.enter_context(
                        profiling.host_syncs())

            def epoch_ended(self, *, phase=None, **kw):
                probe.miou[phase.name] = phase.scores.avg_class_iou()
                super().epoch_ended(phase=phase, **kw)

        self.cls, self.stack = Probe, stack

    def __enter__(self):
        self.loop_mod.StateCallback = self.cls
        return self

    def __exit__(self, *exc):
        self.window.close()
        self.stack.close()
        self.loop_mod.StateCallback = self.base

    def steps(self, name):
        return [x for x in self.seqs if x[0] == name]

    def seconds(self, name, which=None):
        """Seconds from each sequence's callback to the next one's."""
        ts = [x[1] for x in self.steps(name)]
        d = [b - a for a, b in zip(ts, ts[1:])]
        return [d[i - 1] for i in which] if which is not None else d

    def launches(self, name, i):
        """Kernel launches in step ``i`` (from callback i-1 to i)."""
        a, b = self.steps(name)[i - 1][3], self.steps(name)[i][3]
        return {k: b[k] - a[k] for k in b}


def loop_flagship(dev):
    """Phase 15: the loop from the shipped cfgs at full width on an
    on-disk tree (see the module docstring)."""
    import shutil

    from temporal_latticenet_tpu_torch.config import (
        cfgParser, model_config_from_cfg, nr_classes_from_cfg,
        runtime_config_from_cfg)
    from temporal_latticenet_tpu_torch.evaluate_semantics import validate
    from temporal_latticenet_tpu_torch.ops import _cuda
    from temporal_latticenet_tpu_torch.train import checkpoint as ckpt
    from temporal_latticenet_tpu_torch.train import engine
    from temporal_latticenet_tpu_torch.train import loop

    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    data, ckpts = os.path.join(LOOP_DIR, "data"), os.path.join(LOOP_DIR,
                                                               "ckpts")
    os.makedirs(ckpts)
    t0 = time.perf_counter()
    write_kitti_tree(data, LOOP_SCANS)
    tree_s = time.perf_counter() - t0
    train_cfg = loop_cfg("train", LOOP_DIR, data=data, ckpt=ckpts + "/",
                         n=LOOP_SCANS)
    parser = cfgParser(train_cfg)
    cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
    rt = runtime_config_from_cfg(parser)
    try:
        # the loader alone: the train split's windows (augmented)
        ds = loop.make_datasets(parser, cfg, rt)["train"]
        load_s = []
        for i in range(LOOP_SCANS):
            t0 = time.perf_counter()
            ds[i]
            load_s.append(time.perf_counter() - t0)
        from temporal_latticenet_tpu_torch.data import native_loader
        native = native_loader.get_lib() is not None

        # run_training: one epoch's train phase and its valid phase
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        with LoopProbe(loop) as probe:
            t0 = time.perf_counter()
            model, state = loop.run_training(train_cfg,
                                             max_steps=2 * LOOP_SCANS)
            train_wall = time.perf_counter() - t0
        # set-up (model, datasets, the first window) and the first step
        first_step_s = probe.steps("train")[0][1] - t0
        launches_run = _cuda.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [x[2] for x in probe.seqs]
        if len(probe.steps("train")) != LOOP_SCANS or \
                len(probe.steps("valid")) != LOOP_SCANS:
            raise AssertionError(f"the loop ran {len(probe.steps('train'))} "
                                 f"train and {len(probe.steps('valid'))} "
                                 f"valid sequences")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite losses {losses}")
        step_launches = probe.launches("train", LOOP_TIMED[0])
        missing = [k for k in FORWARD_KERNELS
                   if launches_run[k] == 0 or step_launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in the loop: "
                                 f"{missing}")
        step_s = probe.seconds("train", LOOP_TIMED)
        events, wall_us = probe.events
        prof = device_summary(events, wall_us, 1, "step")
        # one loop step cannot be profiled again: its losses are reported
        prof["profiler_lost"] = lost_launches(
            events, probe.launches("train", LOOP_PROFILE_STEP))
        syncs = probe.syncs

        # the checkpoint round trip: the epoch file reloaded into a fresh
        # model gives the trained model's log-probabilities on one window
        name = [f for f in os.listdir(ckpts) if f.endswith("_epoch0.ckpt")]
        if len(name) != 1:
            raise AssertionError(f"epoch checkpoints: {os.listdir(ckpts)}")
        path = os.path.join(ckpts, name[0])
        valid_ds = loop.make_datasets(parser, cfg, rt, ("valid",))["valid"]
        window = engine.SeqBatch.stack([valid_ds[LOOP_SCANS - 1]], dev)
        _, eval_step = engine.make_train_step(model, cfg, rt)
        logp = eval_step(window)[0]
        tv = parser.get_train_vars()
        model2, state2 = engine.create_train_state(
            cfg, rt, tv["lr"], tv["weight_decay"], seed=1, device=dev)
        if ckpt.load(path, model2, state2.optimizer) != state.step:
            raise AssertionError("the checkpoint's step differs")
        _, eval_step2 = engine.make_train_step(model2, cfg, rt)
        logp2 = eval_step2(window)[0]
        if not torch.equal(logp, logp2):
            raise AssertionError(
                f"reloaded log-probabilities differ: "
                f"{float((logp - logp2).abs().max())}")

        # resume: two steps continuing the trained model and optimizer,
        # two from the epoch checkpoint, with equal bits (the step sums in
        # row order, without atomics)
        batches = [engine.SeqBatch.stack([ds[i]], dev) for i in (0, 1)]
        step_c, _ = engine.make_train_step(model, cfg, rt)
        step_r, _ = engine.make_train_step(model2, cfg, rt)
        cont = [float(step_c(state, b, 0.5)[2]["loss"]) for b in batches]
        res = [float(step_r(state2, b, 0.5)[2]["loss"]) for b in batches]
        if res != cont:
            raise AssertionError(f"resumed losses {res} vs continuing {cont}")
        # the faults that check is for: the checkpoint's weights with a
        # fresh optimizer must give another second loss; with AdamW's
        # max_exp_avg_sq dropped (it differs from exp_avg_sq only where
        # that fell) the second loss is recorded
        faults = {}
        for fault in ("fresh optimizer", "max_exp_avg_sq dropped"):
            model2, state2 = engine.create_train_state(
                cfg, rt, tv["lr"], tv["weight_decay"], seed=1, device=dev)
            ckpt.load(path, model2, None if fault == "fresh optimizer"
                      else state2.optimizer)
            for st in state2.optimizer.state.values():
                if "max_exp_avg_sq" in st:
                    st["max_exp_avg_sq"].zero_()
            step_r, _ = engine.make_train_step(model2, cfg, rt)
            faults[fault] = [float(step_r(state2, b, 0.5)[2]["loss"])
                             for b in batches]
            if fault == "fresh optimizer" and faults[fault][1] == cont[1]:
                raise AssertionError(f"a resume with {fault} gives the "
                                     f"continuing second loss {cont[1]}")

        # the bare step on a window loaded in advance
        bare = []
        for i in range(BARE_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, m = step_c(state, batches[0], 0.5)
            float(m["loss"])
            bare.append(time.perf_counter() - t0)
        bare = bare[1:]

        # a reference-schema .pt of the weights (``gn`` for ``gn.gn``)
        # loads strictly
        pt = os.path.join(LOOP_DIR, "weights.pt")
        torch.save({k.replace(".gn.gn.", ".gn."): v.cpu()
                    for k, v in model.state_dict().items()}, pt)
        model3 = engine.create_train_state(cfg, rt, 1e-3, 0.0, seed=2,
                                           device=dev)[0]
        ckpt.load(pt, model3, cfg=cfg)
        differ = [k for k, v in model.state_dict().items()
                  if not torch.equal(v, model3.state_dict()[k])]
        if differ:
            raise AssertionError(f".pt weights differ: {differ}")
        del model2, model3, state2, step_r, eval_step2
        torch.cuda.empty_cache()

        # run_eval of the valid split from the epoch checkpoint, writing
        # devkit predictions
        preds = os.path.join(LOOP_DIR, "predictions")
        eval_cfg = loop_cfg("eval", LOOP_DIR, data=data, ckpt=ckpts,
                            model=name[0], preds=preds)
        with LoopProbe(loop) as eprobe:
            t0 = time.perf_counter()
            miou, phase = loop.run_eval(eval_cfg, split="valid")
            eval_wall = time.perf_counter() - t0
        report = validate(data, preds, split="valid")
        written = sorted(os.listdir(os.path.join(preds, "sequences", "08",
                                                 "predictions")))
        if not report["ok"] or len(written) != LOOP_SCANS:
            raise AssertionError(f"devkit predictions: {len(written)} "
                                 f"files, report {report}")
        if not math.isfinite(miou) or phase.iter_nr != LOOP_SCANS:
            raise AssertionError(f"eval: mIoU {miou}, {phase.iter_nr} seqs")
    finally:
        shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return dict(
        scans_per_sequence=LOOP_SCANS, tree_seconds=tree_s,
        native_loader=native, loader_ms_per_window=statistics.median(
            load_s) * 1e3, loader_ms_all=[x * 1e3 for x in load_s],
        train_wall_s=train_wall, first_step_s=first_step_s,
        steps=len(probe.steps("train")),
        seconds_per_step=statistics.median(step_s),
        quartiles=quartiles(step_s), seconds_all=step_s,
        bare_seconds_per_step=statistics.median(bare),
        bare_quartiles=quartiles(bare), bare_seconds_all=bare,
        valid_seconds_per_seq=statistics.median(probe.seconds("valid")),
        eval_seconds_per_seq=statistics.median(eprobe.seconds("valid")),
        eval_wall_s=eval_wall, eval_miou=miou, valid_miou=probe.miou.get(
            "valid"), losses=losses, resume_losses=res,
        continue_losses=cont, resume_fault_losses=faults,
        host_syncs_per_step=sum(syncs.values()),
        host_syncs_where=syncs, peak_mem_gb=peak_gb,
        launches_per_step=step_launches, launches_run=launches_run,
        predictions_written=len(written), profiled_step=LOOP_PROFILE_STEP,
        **prof)


# ---------------------------------------------------------------------------
# phase 16: the experiment ablations and the slice head's dropout
# ---------------------------------------------------------------------------

def ablation_config(experiment: str, **kw):
    """The flagship with ``experiment``; the experiments that change the
    pointnet's reduced width run behind the early fusion "none" (the JAX
    package's own test has it so; no early fusion cell takes their
    width)."""
    from temporal_latticenet_tpu_torch.models.pointnet import reduced_width

    cfg = model_config(experiment=experiment, **kw)
    if reduced_width(cfg) != cfg.early_channels:
        cfg = dataclasses.replace(cfg,
                                  rnn_modules=("none",) + cfg.rnn_modules[1:])
    return cfg


def ablation_forward(dev, data, experiment):
    """One experiment at the flagship geometry: phases 12-13's forward
    (launches, ``CONFIG_ITERS`` timed forwards, device time), the launches
    this experiment's path must and must not make, and card vs CPU at the
    reduced geometry.  Returns (model, offline logp, result)."""
    cfg = ablation_config(experiment)
    model, fwd, rt = make_forward(FLAGSHIP_RT, dev, cfg=cfg)
    logp, res = config_forward(data, fwd, rt, ABLATION_KERNELS)
    no_k3 = experiment in NO_LOCAL_MEAN
    launches = res["launches"]
    wrong = {k: launches[k] for k in KERNELS
             if (launches[k] > 0) != (k in ABLATION_KERNELS
                                      or (k == "seg_sum_tails" and not no_k3))}
    if wrong:
        raise AssertionError(f"{experiment}: unexpected launches {wrong}")
    res["rnn_modules"] = list(cfg.rnn_modules)
    res["card_vs_cpu"] = card_vs_cpu(dev, cfg)
    return model, logp, res


def ablation_streaming(dev, model, frames, logp_offline):
    """Both streaming paths of ``model``'s experiment (phase 10's
    measurements), each final frame against the offline forward."""
    from temporal_latticenet_tpu_torch.config import RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq

    smodel = LNNSeq(model.cfg, RuntimeConfig(**STREAM_RT), device=dev)
    smodel.load_state_dict(model.state_dict(), strict=True)
    smodel.eval()
    res = {}
    for name, inc in (("plain", False), ("incremental", True)):
        logp, r = stream_path(dev, smodel, frames, incremental=inc)
        r["vs_offline"] = logp_agreement(logp, logp_offline, frames[2][-1],
                                         f"{name} streaming vs offline")
        res[name] = r
    return res


def ablation_step(dev, cfg):
    """One warm and ``ABLATION_STEPS`` timed training steps of ``cfg`` at
    the flagship geometry (full remat, the default K4 route): finite
    losses, launches, peak memory, the device time of one more step under
    ``torch.profiler``; under dropout, every step's dropped share of
    the final frame's slice features."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    _, state, train_step = make_trainer(FLAGSHIP_RT, dev, cfg=cfg)
    batch = train_batch(FLAGSHIP_RT["max_points"], dev)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    state, _, m = train_step(state, batch, 1.0)              # warm step
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    ms, secs = [m], []
    for _ in range(ABLATION_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, m = train_step(state, batch, 1.0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ms.append(m)
    peak = torch.cuda.max_memory_allocated() / 1e9
    events, wall_us = device_events(lambda: train_step(state, batch, 1.0), 1)
    losses = [float(m["loss"]) for m in ms]
    norms = [float(m["grad_norm"]) for m in ms]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or gradient norm: {losses}, "
                             f"{norms}")
    res = dict(launches=launches, losses=losses, grad_norms=norms,
               seconds_per_step=statistics.median(secs), seconds_all=secs,
               peak_mem_gb=peak, **device_summary(events, wall_us, 1, "step"))
    if cfg.dropout_last_layer > 0:
        dropped = [float(m["dropped_share"]) for m in ms]
        if any(abs(d - cfg.dropout_last_layer) > DROPPED_ATOL
               for d in dropped):
            raise AssertionError(f"dropped shares {dropped}, not within "
                                 f"{DROPPED_ATOL} of "
                                 f"{cfg.dropout_last_layer}")
        res["dropped_share"] = dropped
    return res


def ablations(dev, data):
    """Phase 16: every experiment at the flagship geometry (bf16; each one
    forces the per-frame pointnet route: K1-K3, no K4 or K5, and no K3
    without the local mean), card vs CPU; both streaming paths of
    ``pointnet_no_local_mean`` and ``attention_pool`` against their offline
    forward; a training step of ``attention_pool`` and of the flagship with
    ``dropout_last_layer`` 0.2."""
    frames = tuple(torch.as_tensor(a, device=dev) for a in data)
    res = {}
    for exp in EXPERIMENTS:
        model, logp, res[exp] = ablation_forward(dev, data, exp)
        if exp in STREAMED_EXPERIMENTS:
            res[exp]["streaming"] = ablation_streaming(dev, model, frames,
                                                       logp)
        del model
        torch.cuda.empty_cache()
    res["attention_pool"]["train"] = ablation_step(
        dev, ablation_config("attention_pool"))
    torch.cuda.empty_cache()
    res["dropout"] = dict(dropout_last_layer=DROPOUT, train=ablation_step(
        dev, model_config(dropout_last_layer=DROPOUT)))
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 17: data parallelism on the one card
# ---------------------------------------------------------------------------

def dp_batch():
    """The global batch: DP_RANKS sequences of phase 4's geometry, seeds 0,
    1, ...; numpy (B, T, P, ...)."""
    seqs = [lidar_labelled(FLAGSHIP_RT["max_points"], seed=s)
            for s in range(DP_RANKS)]
    return tuple(np.stack(a) for a in zip(*seqs))


def dp_stream_frames():
    """DP_STREAMS sequences of phase 10's geometry (seeds 0, 1, ...) as
    streams: numpy (T, B, P, ...)."""
    seqs = [lidar(STREAM_RT["max_points"], seed=s) for s in range(DP_STREAMS)]
    return tuple(np.ascontiguousarray(np.stack(a, axis=1))
                 for a in zip(*seqs))


def dp_steps(model, state, train_step, batch):
    """``grad_step`` on the initial weights, then one warm training step
    (its launches) and ``DP_TIMED_STEPS`` timed ones: the gradients, the
    losses, the seconds per step, the peak memory and the final weights."""
    from temporal_latticenet_tpu_torch.ops import _cuda

    loss0, grads = train_step.grad_step(batch)
    grads = {k: g.detach().cpu() for k, g in grads.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    state, _, m = train_step(state, batch, 1.0)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    losses, secs = [float(m["loss"])], []
    for _ in range(DP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, m = train_step(state, batch, 1.0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return dict(loss=float(loss0), grads=grads, launches=launches,
                losses=losses, seconds=secs,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                weights={k: p.detach().cpu()
                         for k, p in model.named_parameters()})


def dp_streams(dev, mesh, frames, incremental: bool):
    """The batched streams of ``frames`` (split over ``mesh`` when given)
    on seed-0 flagship weights: the final frame's log-probabilities of
    every stream and the milliseconds of each frame (all streams)."""
    from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
    from temporal_latticenet_tpu_torch.train import engine

    cfg, rt = ModelConfig(), RuntimeConfig(**STREAM_RT)
    model = LNNSeq(cfg, rt, device=dev, seed=0).eval()
    fns = engine.make_streaming_inference_batched(
        model, cfg, rt, mesh=mesh, incremental=incremental, max_new=MAX_NEW)
    pos, val, mask = frames
    carry = fns[0](pos.shape[1])
    ms = []
    for t in range(len(pos)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == len(pos) - 1:
            logp = fns[-1](pos[t], val[t], mask[t], carry)[0]
        else:
            fn = fns[1] if t == 0 or not incremental else fns[2]
            carry = fn(pos[t], val[t], mask[t], carry)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return logp, ms


def _grad_rel_diff(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-12) for k in want)


def _weights_digest(weights: dict) -> str:
    import hashlib
    h = hashlib.sha1()
    for k in sorted(weights):
        h.update(weights[k].numpy().tobytes())
    return h.hexdigest()


def dp_rank(rank: int, world: int, store: str, batch, frames,
            ref_path: str) -> dict:
    """One rank of phase 17 (a child process on the shared card, gloo):
    its sequence's training steps with the all-reduce timed, compared
    with the single process's run in ``ref_path``, then its streams."""
    from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
    from temporal_latticenet_tpu_torch.train.engine import SeqBatch

    mesh = pmesh.make_mesh(world_size=world, rank=rank, backend="gloo",
                           device="cuda", init_method=f"file://{store}")
    try:
        model, state, train_step = make_trainer(FLAGSHIP_RT, mesh.device,
                                                mesh=mesh)
        params = list(model.parameters())
        reduce_ms = []
        all_reduce_mean = pmesh.all_reduce_mean

        def timed_all_reduce(m, tensors):
            tensors = list(tensors)
            # the step's gradient reduction: the parameters' own .grad
            grads = len(tensors) == len(params) and all(
                t is p.grad for t, p in zip(tensors, params))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_mean(m, tensors)
            torch.cuda.synchronize()
            if grads:
                reduce_ms.append((time.perf_counter() - t0) * 1e3)

        pmesh.all_reduce_mean = timed_all_reduce
        try:
            run = dp_steps(model, state, train_step,
                           pmesh.shard_batch(mesh, SeqBatch(*batch)))
        finally:
            pmesh.all_reduce_mean = all_reduce_mean
        # one each in grad_step, the warm step and the timed steps
        if len(reduce_ms) != DP_TIMED_STEPS + 2:
            raise AssertionError(
                f"{len(reduce_ms)} gradient all-reduces timed, not "
                f"{DP_TIMED_STEPS + 2}")
        del model, state, train_step
        ref = torch.load(ref_path, weights_only=True)
        out = dict(
            rank=rank, losses=run["losses"], seconds=run["seconds"],
            launches=run["launches"], peak_mem_gb=run["peak_mem_gb"],
            all_reduce_ms=reduce_ms,
            loss_rel_diff=abs(run["loss"] - float(ref["loss"]))
            / abs(float(ref["loss"])),
            grad_rel_diff=_grad_rel_diff(run["grads"], ref["grads"]),
            weight_max_abs_diff=max(
                float((run["weights"][k] - v).abs().max())
                for k, v in ref["weights"].items()),
            weights_digest=_weights_digest(run["weights"]))
        torch.cuda.empty_cache()
        for name, inc in (("plain", False), ("incremental", True)):
            logp, ms = dp_streams(mesh.device, mesh, frames, inc)
            want = ref[f"streams_{name}"].to(logp.device)
            per = [logp_stats(logp[b], want[b], frames[2][-1, b])
                   for b in range(logp.shape[0])]
            out[f"streams_{name}"] = dict(
                ms_per_frame=ms, bit_equal=bool(torch.equal(logp, want)),
                logp_max_abs_diff=max(st["logp_max_abs_diff"] for st in per),
                argmax_agreement=min(st["argmax_agreement"] for st in per),
                agrees=all(agrees(st) for st in per))
        return out
    finally:
        pmesh.close(mesh)


def data_parallel(dev, train_b1):
    """Phase 17: ``DP_RANKS`` ranks on the one card against one process
    with the whole batch, for the training step and the streams."""
    from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
    from temporal_latticenet_tpu_torch.train.engine import SeqBatch

    import shutil
    batch, frames = dp_batch(), dp_stream_frames()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    try:
        model, state, train_step = make_trainer(FLAGSHIP_RT, dev)
        one = dp_steps(model, state, train_step,
                       SeqBatch(*(torch.as_tensor(a, device=dev)
                                  for a in batch)))
        del model, state, train_step
        ref = dict(loss=torch.tensor(one["loss"]), grads=one["grads"],
                   weights=one["weights"])
        one_ms = {}
        for name, inc in (("plain", False), ("incremental", True)):
            logp, one_ms[name] = dp_streams(dev, None, frames, inc)
            ref[f"streams_{name}"] = logp.cpu()
            del logp
        ref_path = os.path.join(DP_DIR, "reference.pt")
        torch.save(ref, ref_path)
        del ref
        torch.cuda.empty_cache()
        ranks = pmesh.spawn(dp_rank, DP_RANKS,
                            (os.path.join(DP_DIR, "store"), batch, frames,
                             ref_path), timeout=DP_TIMEOUT)
    finally:
        shutil.rmtree(DP_DIR, ignore_errors=True)

    faults = []
    for r in ranks:
        if r["loss_rel_diff"] > DP_LOSS_RTOL:
            faults.append(f"rank {r['rank']} loss {r['loss_rel_diff']}")
        if r["grad_rel_diff"] > DP_GRAD_REL:
            faults.append(f"rank {r['rank']} gradients {r['grad_rel_diff']}")
        if r["weight_max_abs_diff"] > DP_WEIGHT_ATOL:
            faults.append(f"rank {r['rank']} weights "
                          f"{r['weight_max_abs_diff']}")
        missing = [k for k in FORWARD_KERNELS if r["launches"][k] == 0]
        if missing:
            faults.append(f"rank {r['rank']} launched no {missing}")
        for name in ("plain", "incremental"):
            if not r[f"streams_{name}"]["agrees"]:
                faults.append(f"rank {r['rank']} streams {name}: "
                              f"{r[f'streams_{name}']}")
    if len({r["weights_digest"] for r in ranks}) != 1:
        faults.append("the ranks' weights differ")
    if not all(math.isfinite(x) for r in ranks for x in r["losses"]):
        faults.append("non-finite losses")
    if faults:
        raise AssertionError("; ".join(faults))
    rank_secs = [statistics.median(r["seconds"]) for r in ranks]
    return dict(
        note=(f"{DP_RANKS} ranks share one card over gloo: this checks "
              f"correctness, not scaling"),
        ranks=DP_RANKS, sequences_per_rank=1,
        seconds_per_step_ranks=rank_secs,
        seconds_all_ranks=[r["seconds"] for r in ranks],
        quartiles_ranks=[quartiles(r["seconds"]) for r in ranks],
        seconds_per_step_b2=statistics.median(one["seconds"]),
        quartiles_b2=quartiles(one["seconds"]), seconds_all_b2=one["seconds"],
        seconds_per_step_b1_phase8=train_b1,
        peak_mem_gb_ranks=[r["peak_mem_gb"] for r in ranks],
        peak_mem_gb_b2=one["peak_mem_gb"],
        all_reduce_ms_per_step=[statistics.median(r["all_reduce_ms"])
                                for r in ranks],
        all_reduce_ms_all=[r["all_reduce_ms"] for r in ranks],
        launches_rank_step=ranks[0]["launches"],
        launches_b2_step=one["launches"],
        losses_ranks=[r["losses"] for r in ranks], losses_b2=one["losses"],
        loss_rel_diff=max(r["loss_rel_diff"] for r in ranks),
        grad_rel_diff=max(r["grad_rel_diff"] for r in ranks),
        weight_max_abs_diff=max(r["weight_max_abs_diff"] for r in ranks),
        streams={name: dict(
            streams=DP_STREAMS,
            ms_per_frame_ranks=[statistics.median(r[f"streams_{name}"][
                "ms_per_frame"]) for r in ranks],
            ms_per_frame_one_process=statistics.median(one_ms[name]),
            ms_all_ranks=[r[f"streams_{name}"]["ms_per_frame"]
                          for r in ranks],
            ms_all_one_process=one_ms[name],
            bit_equal=all(r[f"streams_{name}"]["bit_equal"] for r in ranks),
            logp_max_abs_diff=max(r[f"streams_{name}"]["logp_max_abs_diff"]
                                  for r in ranks))
            for name in ("plain", "incremental")},
        tolerance=dict(loss_rtol=DP_LOSS_RTOL, grad_rel=DP_GRAD_REL,
                       weight_atol=DP_WEIGHT_ATOL, logp_atol=LOGP_ATOL,
                       argmax_agree=ARGMAX_AGREE))


# ---------------------------------------------------------------------------
# phase 18: the utilities on the card
# ---------------------------------------------------------------------------

def utilities(dev):
    """Phase 18: capacity autotuning, a ``profiling.trace`` of one flagship
    forward, and ``visualize_cli`` on one sequence."""
    import shutil
    import types

    from temporal_latticenet_tpu_torch import visualize_cli
    from temporal_latticenet_tpu_torch.config import (ModelConfig,
                                                      RuntimeConfig,
                                                      cfgParser,
                                                      runtime_config_from_cfg)
    from temporal_latticenet_tpu_torch.ops import _cuda
    from temporal_latticenet_tpu_torch.train.engine import sequence_lattice
    from temporal_latticenet_tpu_torch.utils import profiling
    from temporal_latticenet_tpu_torch.utils.autotune import \
        autotune_capacities

    out = {}
    shutil.rmtree(UTIL_DIR, ignore_errors=True)
    try:
        # autotune over two sequences of phase 4's data; with a headroom of
        # 256 each capacity is 256 times the level's largest count
        rt = RuntimeConfig(**FLAGSHIP_RT)
        seqs = [lidar(FLAGSHIP_RT["max_points"], seed=s) for s in (0, 1)]
        pairs = [(pos, mask) for pos, _, mask in seqs]
        t0 = time.perf_counter()
        _cuda.reset_launch_counts()
        caps = autotune_capacities(pairs, 2, rt.sigma, device=dev)
        out["autotune_seconds"] = time.perf_counter() - t0
        out["autotune_launches"] = _cuda.launch_counts()
        exact = autotune_capacities(pairs, 2, rt.sigma, headroom=256.0,
                                    device=dev)
        counts = []
        for pos, val, mask in seqs:
            lat, _, _ = sequence_lattice(
                ModelConfig(), rt, *(torch.as_tensor(a, device=dev)
                                     for a in (pos, val, mask)))
            counts.append([int(lvl.counts[-1]) for lvl in lat.levels])
        worst = [max(c) for c in zip(*counts)]
        if [c // 256 for c in exact] != worst:
            raise AssertionError(f"autotune counts {[c // 256 for c in exact]}"
                                 f" vs the flagship build's {worst}")
        missing = [k for k in AUTOTUNE_KERNELS
                   if out["autotune_launches"][k] == 0]
        if missing:
            raise AssertionError(f"autotune launched no {missing}")
        out.update(autotune_capacities=list(caps), flagship_counts=counts)

        # one flagship forward under profiling.trace
        model, fwd, _ = make_forward(FLAGSHIP_RT, dev)
        fwd(*seqs[0])
        path = os.path.join(UTIL_DIR, "trace", profiling.TRACE_FILE)
        out["trace_lacking"] = []
        for tries in range(1, PROFILE_TRIES + 1):
            t0 = time.perf_counter()
            with profiling.trace(os.path.dirname(path)):
                fwd(*seqs[0])
            out["trace_seconds"] = time.perf_counter() - t0
            with open(path) as fh:
                names = {e.get("name", "")
                         for e in json.load(fh)["traceEvents"]}
            kernels = {hand_written(n) for n in names} - {None}
            lacking = ({"distribute", "pointnet"} - names) \
                | (set(FORWARD_KERNELS) - kernels)
            if not lacking:
                break
            # the profiler now and then loses device events (device_events)
            out["trace_lacking"].append(sorted(lacking))
            if tries < PROFILE_TRIES:
                profile_retry_pause(tries)
        else:
            raise AssertionError(f"{PROFILE_TRIES} traces lack "
                                 f"{out['trace_lacking']}")
        del model, fwd
        out["trace_bytes"] = os.path.getsize(path)
        out["trace_kernels"] = sorted(kernels)

        # visualize_cli on one sequence of the reduced geometry, shipped
        # eval cfg (the flagship, AFlow at the bottleneck), no --render
        pos, val, mask = lidar(SMALL_RT["max_points"])
        frames = [types.SimpleNamespace(positions=pos[t], values=val[t],
                                        mask=mask[t])
                  for t in range(len(pos))]
        vis_dir = os.path.join(UTIL_DIR, "vis")
        cfg_path = os.path.join(ROOT, "seq_config",
                                "lnn_eval_semantic_kitti.cfg")
        t0 = time.perf_counter()
        visualize_cli.run(cfg_path, None, vis_dir,
                          datasets={"valid": [frames]}, device=dev)
        out["visualize_seconds"] = time.perf_counter() - t0
        written = sorted(os.listdir(vis_dir))
        want = [f"aflow_frame{t}.npz" for t in range(1, len(pos))]
        if written != want:
            raise AssertionError(f"visualize_cli wrote {written}")
        cap = runtime_config_from_cfg(cfgParser(cfg_path)).capacities(2)[2]
        for name in written:
            data = np.load(os.path.join(vis_dir, name))
            w = [data[k] for k in data.files if k.endswith("aflow_weights")]
            n = [data[k] for k in data.files
                 if k.endswith("aflow_neighbors")]
            if len(w) != 1 or len(n) != 1:
                raise AssertionError(f"{name} holds {data.files}")
            if not np.isfinite(w[0]).all() or not (w[0] > 0).any():
                raise AssertionError(f"{name}: weights not finite or all 0")
            if n[0].min() < 0 or n[0].max() >= cap:
                raise AssertionError(f"{name}: neighbors outside [0, {cap})")
        out["visualize_files"] = written
    finally:
        shutil.rmtree(UTIL_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the accuracy experiments (train_lidar, overfit_lidar, the
# occupancy probe) at the small scale
# ---------------------------------------------------------------------------

class ExperimentProbe:
    """Stands in for the loop's ``StateCallback`` (a subclass of it) in
    ``run_training`` and ``run_eval``: the host clock, the phase, its epoch,
    the loss and the launch counts at every sequence and at every epoch's
    start, and each epoch's valid IoUs inside ``run_training``.  A training
    step's launches are the counts' change since the record before it (the
    step before, or its epoch's start); its seconds run from the callback
    of the step before in the same epoch to its own (the loader's wait, the
    batch's copy, the step and the host reads)."""

    def __init__(self, loop_mod):
        from temporal_latticenet_tpu_torch.ops import _cuda
        self.loop_mod, self.base = loop_mod, loop_mod.StateCallback
        self.run_training = loop_mod.run_training
        self.records, self.valid_epochs, self.training = [], [], False
        probe = self

        def record(kind, phase, loss=None):
            probe.records.append(dict(
                kind=kind, phase=phase.name, grad=phase.grad,
                epoch=phase.epoch_nr, t=time.perf_counter(), loss=loss,
                launches=_cuda.launch_counts()))

        class Probe(self.base):
            def after_forward_pass(self, *, phase=None, **kw):
                record("seq", phase, float(kw["loss"]))
                super().after_forward_pass(phase=phase, **kw)

            def epoch_started(self, *, phase=None, **kw):
                record("start", phase)
                super().epoch_started(phase=phase, **kw)

            def epoch_ended(self, *, phase=None, **kw):
                if probe.training and not phase.grad:
                    miou, iou = phase.scores.compute_stats()
                    probe.valid_epochs.append(dict(
                        epoch=phase.epoch_nr, miou=miou, iou=iou))
                super().epoch_ended(phase=phase, **kw)

        def training(*args, **kwargs):
            probe.training = True
            try:
                return probe.run_training(*args, **kwargs)
            finally:
                probe.training = False

        self.cls, self.training_fn = Probe, training

    def __enter__(self):
        self.loop_mod.StateCallback = self.cls
        self.loop_mod.run_training = self.training_fn
        return self

    def __exit__(self, *exc):
        self.loop_mod.StateCallback = self.base
        self.loop_mod.run_training = self.run_training

    def steps(self):
        """Each training step with its launches and, but for an epoch's
        first, its seconds."""
        out = []
        for prev, r in zip(self.records, self.records[1:]):
            if r["kind"] != "seq" or not r["grad"]:
                continue
            same = prev["kind"] == "seq" and prev["grad"] \
                and prev["epoch"] == r["epoch"]
            out.append(dict(epoch=r["epoch"], loss=r["loss"],
                            seconds=r["t"] - prev["t"] if same else None,
                            launches={k: r["launches"][k] - prev["launches"][k]
                                      for k in r["launches"]}))
        return out


def measured_run(fn, argv, cfg_path=None, windows: int = LOADER_WINDOWS):
    """One experiment's ``main(argv)`` on the card under
    :class:`ExperimentProbe`, with the launch counts set to 0 just before
    it: its results, the seconds of its training steps (median and
    quartiles), each epoch's mean training loss and valid IoUs, each
    kernel's fewest and most launches in a step, the launches of the whole
    run, its peak memory and, from ``cfg_path``, the loader's seconds per
    train window (the first ``windows``, through the loader alone)."""
    from temporal_latticenet_tpu_torch.config import (
        cfgParser, model_config_from_cfg, nr_classes_from_cfg,
        runtime_config_from_cfg)
    from temporal_latticenet_tpu_torch.ops import _cuda
    from temporal_latticenet_tpu_torch.train import loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    with ExperimentProbe(loop) as probe:
        t0 = time.perf_counter()
        results = fn(argv)
        wall = time.perf_counter() - t0
    launches_run = _cuda.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = probe.steps()
    secs = [s["seconds"] for s in steps if s["seconds"] is not None]
    epochs = sorted({s["epoch"] for s in steps})
    out = dict(
        argv=list(argv), wall_s=wall, steps=len(steps), epochs=epochs,
        seconds_per_step=statistics.median(secs) if secs else None,
        quartiles=quartiles(secs) if len(secs) > 1 else None,
        epoch_losses={e: statistics.fmean(s["loss"] for s in steps
                                          if s["epoch"] == e)
                      for e in epochs},
        losses_finite=all(math.isfinite(r["loss"]) for r in probe.records
                          if r["kind"] == "seq"),
        launches_per_step_min={k: min(s["launches"][k] for s in steps)
                               for k in KERNELS} if steps else {},
        launches_per_step_max={k: max(s["launches"][k] for s in steps)
                               for k in KERNELS} if steps else {},
        valid_epochs=probe.valid_epochs, launches_run=launches_run,
        peak_mem_gb=peak_gb, results=results)
    if cfg_path:
        parser = cfgParser(cfg_path)
        cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
        ds = loop.make_datasets(parser, cfg, runtime_config_from_cfg(parser),
                                splits=("train",))["train"]
        n = min(windows, len(ds))
        t0 = time.perf_counter()
        for i in range(n):
            ds[i]
        out["loader_s_per_window"] = (time.perf_counter() - t0) / n
    return out


def check_experiment(name, r, keys, ckpt_dir=None, epochs=None):
    """Phase 19's checks of one run: finite losses; K1-K4 launched in every
    training step and K5 in none; the trained epochs; one checkpoint an
    epoch; the results' keys and IoUs."""
    if not r["losses_finite"]:
        raise AssertionError(f"{name}: non-finite losses")
    if not r["steps"]:
        raise AssertionError(f"{name}: no training step")
    idle = [k for k in FORWARD_KERNELS if r["launches_per_step_min"][k] == 0]
    if idle:
        raise AssertionError(f"{name}: steps without {idle}: "
                             f"{r['launches_per_step_min']}")
    if r["launches_run"]["sorted_segment_max_window"]:
        raise AssertionError(f"{name}: K5 launched off the packed route")
    if epochs is not None and r["epochs"] != list(epochs):
        raise AssertionError(f"{name}: trained epochs {r['epochs']}, "
                             f"not {list(epochs)}")
    if ckpt_dir is not None:
        found = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                       if (m := re.search(r"_epoch(\d+)\.ckpt$", f)))
        if found != list(range(max(epochs) + 1)):
            raise AssertionError(f"{name}: epoch checkpoints {found}")
    res = r["results"]
    if sorted(res) != sorted(keys):
        raise AssertionError(f"{name}: results keys {sorted(res)}")
    ious = [v for k, v in res.items() if k.startswith("miou_")]
    for k in ("iou_train", "iou_valid"):
        ious += list(res.get(k, {}).values())
    if not all(0.0 <= v <= 1.0 for v in ious):
        raise AssertionError(f"{name}: IoUs outside [0, 1]: {res}")


def experiment_summary(r) -> dict:
    """What phase 19 reports of a run (the results without paths)."""
    res = r["results"]
    return dict({k: v for k, v in r.items() if k != "results"},
                miou_train=res["miou_train"], miou_valid=res["miou_valid"],
                iou_valid=res.get("iou_valid"),
                loader_s_per_seq=res.get("loader_s_per_seq"))


def lidar_experiments(dev):
    """Phase 19: ``occupancy_worlds`` at the small scale; ``train_lidar``'s
    three variants, a resume and the generalization flags; the overfit's
    smoke run, its ``.label`` files scored again by ``evaluate_semantics``
    (see the module docstring)."""
    import shutil

    from temporal_latticenet_tpu_torch import evaluate_semantics
    from temporal_latticenet_tpu_torch.experiments import (occupancy_worlds,
                                                           overfit_lidar,
                                                           train_lidar)
    from temporal_latticenet_tpu_torch.ops import _cuda

    out = {}
    shutil.rmtree(EXP_DIR, ignore_errors=True)
    try:
        # the small scale's worst union counts stay under its capacities
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        occ = occupancy_worlds.main(EXP_OCCUPANCY)
        occ.update(seconds=time.perf_counter() - t0,
                   launches=_cuda.launch_counts())
        out["occupancy_worlds"] = occ
        full = [lvl for lvl, (w, c) in enumerate(zip(occ["worst"],
                                                     occ["caps"])) if w >= c]
        if full:
            raise AssertionError(f"levels {full} saturated: worst "
                                 f"{occ['worst']} of {occ['caps']}")
        if not all(occ["launches"][k] for k in AUTOTUNE_KERNELS):
            raise AssertionError(f"occupancy launches {occ['launches']}")

        # the moving-class variants on one set of worlds, then a resume
        m1 = os.path.join(EXP_DIR, "m1")
        runs = [(v, ["--variant", v, "--moving", "1", "--epochs",
                     str(EXP_EPOCHS)], range(EXP_EPOCHS), m1)
                for v in train_lidar.VARIANTS]
        runs.append(("temporal_resume",
                     ["--variant", "temporal", "--moving", "1", "--resume",
                      "--epochs", str(EXP_EPOCHS + 1)],
                     range(EXP_EPOCHS, EXP_EPOCHS + 1), m1))
        # the generalization run's flags
        m0 = os.path.join(EXP_DIR, "m0")
        runs.append(("generalization",
                     ["--variant", "temporal", "--moving", "0", "--aug", "1",
                      "--remat", "selective", "--epochs", str(EXP_EPOCHS)],
                     range(EXP_EPOCHS), m0))
        for name, flags, epochs, root in runs:
            variant = flags[1]
            argv = flags + EXP_SIZE + ["--root", root, "--out", os.path.join(
                root, f"{name}.json")]
            r = measured_run(train_lidar.main, argv,
                             os.path.join(root, f"cfg_{variant}.cfg"))
            check_experiment(name, r, TRAIN_LIDAR_KEYS,
                             os.path.join(root, f"ckpt_{variant}"), epochs)
            out[name] = experiment_summary(r)

        # the overfit: the loss falls; evaluate_semantics on the written
        # .label files gives run_eval's valid mIoU
        root = os.path.join(EXP_DIR, "overfit")
        r = measured_run(overfit_lidar.main,
                         ["--smoke", "--epochs", str(OVERFIT_EPOCHS),
                          "--root", root])
        check_experiment("overfit", r, OVERFIT_KEYS,
                         os.path.join(root, "ckpt"), range(OVERFIT_EPOCHS))
        losses = r["epoch_losses"]
        if not losses[OVERFIT_EPOCHS - 1] < losses[0]:
            raise AssertionError(f"overfit: epoch losses {losses}")
        miou, _ = evaluate_semantics.run(os.path.join(root, "data"),
                                         os.path.join(root, "preds"),
                                         split="valid")
        r["evaluate_semantics_miou_valid"] = float(miou)
        if abs(miou - r["results"]["miou_valid"]) > 1e-9:
            raise AssertionError(f"evaluate_semantics mIoU {miou} vs "
                                 f"run_eval's {r['results']['miou_valid']}")
        out["overfit"] = experiment_summary(r)
    finally:
        shutil.rmtree(EXP_DIR, ignore_errors=True)
    return out


def log_experiments(exp, dline):
    """Phase 19's lines of the log."""
    occ = exp["occupancy_worlds"]
    log(f"[experiments] occupancy_worlds worst {occ['worst']} of "
        f"{occ['caps']} over {len(occ['windows'])} windows in "
        f"{occ['seconds']:.1f} s")
    for name, r in exp.items():
        if name == "occupancy_worlds":
            continue
        loader = r.get("loader_s_per_window") or r["loader_s_per_seq"]
        log(f"[experiments] {name}: {r['steps']} steps, "
            f"{r['seconds_per_step']:.4f} s/step (quartiles "
            f"{r['quartiles']}), loader {loader:.4f} s/window, peak "
            f"{r['peak_mem_gb']:.2f} GB, launches a step "
            f"{r['launches_per_step_min']} - {r['launches_per_step_max']}, "
            f"epoch losses {json.dumps(r['epoch_losses'])}, mIoU train "
            f"{r['miou_train']:.4f} valid {r['miou_valid']:.4f}, "
            f"{r['wall_s']:.1f} s on {dline}")


# ---------------------------------------------------------------------------
# phase 20: the benchmark drivers
# ---------------------------------------------------------------------------

def run_driver(module: str, flags, packed: bool):
    """``python -m temporal_latticenet_tpu_torch.<module> <flags>`` in
    ``BENCH_DIR``; returns (its JSON lines, its seconds).  Fails on a
    non-zero exit."""
    env = dict(os.environ, PYTHONPATH=ROOT,
               TLN_BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    env.pop("TLN_MAXSCAN_PACKED", None)
    if packed:
        env["TLN_MAXSCAN_PACKED"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"temporal_latticenet_tpu_torch.{module}",
         *flags], cwd=BENCH_DIR, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} {flags}: rc {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = [json.loads(s) for s in proc.stdout.strip().splitlines()
             if s.startswith("{")]
    if not lines:
        raise AssertionError(f"{module} {flags}: no JSON line: "
                             f"{proc.stdout[-1000:]}")
    return lines, secs


def _check_launches(name, launches, want, never=()):
    missing = [k for k in want if not launches.get(k)]
    extra = [k for k in never if launches.get(k)]
    if missing or extra:
        raise AssertionError(f"{name}: launches {launches} (not launched: "
                             f"{missing}; launched: {extra})")


def benches(dev):
    """Phase 20: each driver as a user runs it (see the module
    docstring)."""
    import shutil

    total = torch.cuda.get_device_properties(dev).total_memory
    out = {}
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    os.makedirs(BENCH_DIR)
    try:
        for name, module, flags, packed in BENCH_RUNS:
            lines, secs = run_driver(module, flags, packed)
            line = lines[-1]
            r = dict(line=line, process_seconds=secs)
            if module == "bench":
                keys = BENCH_KEYS
                with open(os.path.join(BENCH_DIR, "bench_details_torch.json")) \
                        as fh:
                    det = json.load(fh)
                r["details"] = det
                if line["metric"] != "semantickitti_4frame_seq_inference":
                    raise AssertionError(f"bench metric {line['metric']}")
                if det["saturated"] or det["trim_overflowed"] \
                        or det["vertex_overflow"]:
                    raise AssertionError(f"bench: saturated "
                                         f"{det['saturated']}, trim overflow "
                                         f"{det['trim_overflowed']}, vertex "
                                         f"overflow {det['vertex_overflow']}")
                if det.get("reps") != 3:
                    raise AssertionError(f"bench: {det.get('reps')} "
                                         f"repetitions")
                _check_launches(name, det["launches_per_forward"],
                                FORWARD_KERNELS,
                                ("sorted_segment_max_window",))
                peak = det["peak_mem_bytes"]
            elif module == "train_bench":
                keys = TRAIN_BENCH_KEYS
                det = lines[-2]["details"]
                r["details"] = det
                if line["metric"] != "semantickitti_4frame_train_step":
                    raise AssertionError(f"train_bench metric "
                                         f"{line['metric']}")
                if line["vertex_overflow"]:
                    raise AssertionError(f"{name}: vertex overflow")
                if packed:
                    _check_launches(name, det["launches_per_step"],
                                    tuple(KERNELS))
                else:
                    _check_launches(name, det["launches_per_step"],
                                    FORWARD_KERNELS,
                                    ("sorted_segment_max_window",))
                peak = det["peak_mem_bytes"]
            else:
                keys = STREAMING_KEYS + STREAMS_KEYS
                if line["streams"] != BENCH_STREAMS \
                        or line["mesh_devices"] != 1:
                    raise AssertionError(f"bench_streaming: streams "
                                         f"{line['streams']} over "
                                         f"{line['mesh_devices']} devices")
                if not all(line[k] > 0 for k in keys if k.endswith("_ms")):
                    raise AssertionError(f"bench_streaming: {line}")
                peak = None
            if sorted(line) != sorted(keys):
                raise AssertionError(f"{name}: keys {sorted(line)}, the JAX "
                                     f"script's {sorted(keys)}")
            if "value" in line and not line["value"] > 0:
                raise AssertionError(f"{name}: value {line['value']}")
            if peak is not None and not 0 < peak < total:
                raise AssertionError(f"{name}: peak {peak} bytes of {total}")
            out[name] = r
    finally:
        shutil.rmtree(BENCH_DIR, ignore_errors=True)
    return out


def log_benches(b, dline):
    """Phase 20's lines of the log."""
    for name, r in b.items():
        log(f"[benches] {name} ({r['process_seconds']:.1f} s of process) on "
            f"{dline}: {json.dumps(r['line'])}")
        det = r.get("details")
        if name == "bench":
            log(f"[benches] bench: {det['seconds_per_sequence']:.4f} s/seq, "
                f"repetitions {det['seconds_per_sequence_reps']} (min "
                f"{det['seconds_per_sequence_min']:.4f}, max "
                f"{det['seconds_per_sequence_max']:.4f}) of {det['iters']} "
                f"sequences; single {det['seconds_per_sequence_single']:.4f},"
                f" synced {det.get('seconds_per_sequence_synced')}, "
                f"pipelined {det.get('seconds_per_sequence_pipelined')}; "
                f"first forward {det['compile_seconds']:.2f} s; host syncs "
                f"in a forward {det['host_syncs_per_forward']}; launches "
                f"{det['launches_per_forward']}; occupancy "
                f"{det['occupancy_final_union']}; peak "
                f"{det['peak_mem_bytes'] / 1e9:.2f} GB")
        elif det is not None:
            log(f"[benches] {name}: route {det['pointnet_max_route']}; "
                f"launches a step {det['launches_per_step']}; peak "
                f"{det['peak_mem_bytes'] / 1e9:.2f} GB; synced steps "
                f"{det['seconds_per_step_synced_all']}")


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
            # the reason also reaches the end of the standard error
            traceback.print_exc(file=sys.stderr)
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
        tcc = phase("train_card_vs_cpu", lambda: train_card_vs_cpu(dev))
        for route, r in (tcc or {}).get("routes", {}).items():
            log(f"[train_card_vs_cpu] {route} route: |d loss| "
                f"{r['loss_abs_diff']:.3g}, smallest cosine "
                f"{r['min_grad_cosine']:.6f} ({r['min_cosine_param']}), "
                f"norms {r['grad_norm_card']:.6g} card / "
                f"{r['grad_norm_cpu']:.6g} CPU; launches {r['launches']}")
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

        torch.cuda.empty_cache()
        lp = phase("loop", lambda: loop_flagship(dev))
        if lp:
            log(f"[loop] loader {lp['loader_ms_per_window']:.1f} ms per "
                f"window (native {lp['native_loader']}); loop "
                f"{lp['seconds_per_step']:.4f} s/step (quartiles "
                f"{lp['quartiles']}) vs bare step "
                f"{lp['bare_seconds_per_step']:.4f} s (quartiles "
                f"{lp['bare_quartiles']}) on {dline}; valid "
                f"{lp['valid_seconds_per_seq']:.4f} s/seq, eval "
                f"{lp['eval_seconds_per_seq']:.4f} s/seq; host syncs per "
                f"step {lp['host_syncs_per_step']} "
                f"{json.dumps(lp['host_syncs_where'])}; peak "
                f"{lp['peak_mem_gb']:.2f} GB; launches per step "
                f"{lp['launches_per_step']}; "
                f"{lp['device_ms_per_step']:.2f} device ms, device busy "
                f"{lp['device_busy_share']:.3f}; hand-written "
                f"{json.dumps(lp['hand_written'])}; losses {lp['losses']}; "
                f"resume {lp['resume_losses']} vs {lp['continue_losses']}, "
                f"faulty resumes {json.dumps(lp['resume_fault_losses'])}")

        torch.cuda.empty_cache()
        abl = phase("ablations", lambda: ablations(dev, data))
        for exp in EXPERIMENTS if abl else ():
            r = abl[exp]
            log(f"[ablations] {exp}: {r['seconds_per_seq']:.4f} s/seq "
                f"(quartiles {r['quartiles']}), {r['device_ms_per_seq']:.2f} "
                f"device ms and {r['device_launches_per_seq']:.0f} launches "
                f"per seq, peak {r['peak_mem_gb']:.2f} GB on {dline}; "
                f"launches {r['launches']}; card vs CPU "
                f"{json.dumps(r['card_vs_cpu'])}")
            for name, st in (r.get("streaming") or {}).items():
                log(f"[ablations] {exp} streaming {name}: non-final "
                    f"{st['non_final_ms']:.2f} ms, final {st['final_ms']:.2f} "
                    f"ms, {st['device_ms_per_frame']:.2f} device ms per "
                    f"frame; launches per frame {st['launches_per_frame']}; "
                    f"vs offline {json.dumps(st['vs_offline'])}")
        for name, r in (("attention_pool", (abl or {}).get(
                "attention_pool", {}).get("train")),
                        ("dropout", (abl or {}).get("dropout", {}).get(
                            "train"))):
            if r:
                log(f"[ablations] {name} step: {r['seconds_per_step']:.4f} "
                    f"s/step, {r['device_ms_per_step']:.2f} device ms, "
                    f"busy {r['device_busy_share']:.3f}, peak "
                    f"{r['peak_mem_gb']:.2f} GB; losses "
                    f"{r['losses']}; launches {r['launches']}; dropped "
                    f"{r.get('dropped_share')}")

        torch.cuda.empty_cache()
        dp = phase("data_parallel", lambda: data_parallel(
            dev, (train or {}).get("seconds_per_step")))
        if dp:
            log(f"[data_parallel] {dp['note']}; s/step ranks "
                f"{dp['seconds_per_step_ranks']} (quartiles "
                f"{dp['quartiles_ranks']}), B = 2 one process "
                f"{dp['seconds_per_step_b2']:.4f} (quartiles "
                f"{dp['quartiles_b2']}), B = 1 (phase 8, packed route) "
                f"{dp['seconds_per_step_b1_phase8']} on {dline}; peak "
                f"{dp['peak_mem_gb_ranks']} GB a rank, "
                f"{dp['peak_mem_gb_b2']:.2f} GB B = 2; all-reduce "
                f"{dp['all_reduce_ms_per_step']} ms a step; launches a "
                f"rank-step {dp['launches_rank_step']}; loss "
                f"{dp['loss_rel_diff']}, gradients {dp['grad_rel_diff']}, "
                f"weights {dp['weight_max_abs_diff']} from one process")
            for name, st in dp["streams"].items():
                log(f"[data_parallel] streams {name}: "
                    f"{st['ms_per_frame_ranks']} ms a frame of a rank's "
                    f"{DP_STREAMS // DP_RANKS} streams, "
                    f"{st['ms_per_frame_one_process']:.2f} ms of one "
                    f"process's {DP_STREAMS}; bit-equal {st['bit_equal']}, "
                    f"max |d logp| {st['logp_max_abs_diff']}")
        torch.cuda.empty_cache()
        ut = phase("utilities", lambda: utilities(dev))
        if ut:
            log(f"[utilities] autotune {ut['autotune_capacities']} in "
                f"{ut['autotune_seconds']:.3f} s, launches "
                f"{ut['autotune_launches']}; trace {ut['trace_seconds']:.3f}"
                f" s, {ut['trace_bytes']} bytes, kernels "
                f"{ut['trace_kernels']} (traces taken again, lacking: "
                f"{ut['trace_lacking']}); visualize_cli "
                f"{ut['visualize_seconds']:.3f} s, {ut['visualize_files']} "
                f"on {dline}")
        torch.cuda.empty_cache()
        exp = phase("experiments", lambda: lidar_experiments(dev))
        if exp:
            log_experiments(exp, dline)
        torch.cuda.empty_cache()
        bn = phase("benches", lambda: benches(dev))
        if bn:
            log_benches(bn, dline)

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
            launches_loop=((report.get("loop") or {}).get(
                "launches_per_step") or {}).get(name, 0),
            launches_ablations={
                exp: ((report.get("ablations") or {}).get(exp) or {}).get(
                    "launches", {}).get(name, 0) for exp in EXPERIMENTS},
            loop_device_ms_per_step=(((report.get("loop") or {}).get(
                "hand_written") or {}).get(name) or {}).get(
                "device_ms_per_step"),
            launches_dp_rank_step=((report.get("data_parallel") or {}).get(
                "launches_rank_step") or {}).get(name, 0),
            launches_autotune=((report.get("utilities") or {}).get(
                "autotune_launches") or {}).get(name, 0),
            launches_bench=((((report.get("benches") or {}).get("bench")
                               or {}).get("details") or {}).get(
                "launches_per_forward") or {}).get(name, 0),
            launches_train_bench={
                run: (r["details"]["launches_per_step"]).get(name, 0)
                for run, r in (report.get("benches") or {}).items()
                if run.startswith("train_bench")},
            launches_experiments_step={
                run: r["launches_per_step_min"].get(name, 0)
                for run, r in (report.get("experiments") or {}).items()
                if "launches_per_step_min" in r},
            cases=k.get("cases")))
    report["device_line"] = dline
    report["profiler_retries"] = PROFILER_RETRIES
    log(f"[profiler] {len(PROFILER_RETRIES)} windows taken again after "
        f"losing device events: {PROFILER_RETRIES}")
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
