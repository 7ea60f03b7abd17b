"""Occupancy probe of the on-disk ``train_lidar`` worlds.

Re-measure occupancy before choosing capacities for a new generator and
scale: this writes worlds at the requested scale and moving setting with
``train_lidar``'s own writer, loads 4-scan pose-compensated windows
through the loader, builds each window's sequence lattice
(``ops/seq_lattice.build_sequence_lattice``; K1-K3 on the card) and prints
the worst-case per-level union counts against the scale's capacities.  A
level whose count reaches its capacity has dropped vertices.

    python -m temporal_latticenet_tpu_torch.experiments.occupancy_worlds \\
        --scale medium --moving 0 [--cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..config import RuntimeConfig
from ..data.kitti import SemanticKittiDataset
from ..device import resolve_device
from ..ops import seq_lattice as sl
from .train_lidar import SCALES, write_moving_world


def union_counts(positions, mask, rt: RuntimeConfig, caps,
                 device) -> list[int]:
    """Each level's occupied slots (slot 0 included) after the window's
    last frame."""
    with torch.no_grad():
        lat = sl.build_sequence_lattice(
            torch.as_tensor(positions, device=device),
            torch.as_tensor(mask, device=device), rt.sigma, caps, 2)
    return [int(lvl.counts[-1]) for lvl in lat.levels]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="medium")
    ap.add_argument("--moving", type=int, default=0)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--worlds", type=int, default=2)
    ap.add_argument("--stride", type=int, default=3,
                    help="probe every stride-th window")
    ap.add_argument("--cap0", type=int, default=0,
                    help="override level-0 probe capacity (a saturated probe"
                         " hides the true occupancy)")
    ap.add_argument("--min-cap", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    beams, n_az, max_points, cap0, min_cap = SCALES[args.scale]
    cap0 = args.cap0 or cap0
    min_cap = args.min_cap or min_cap
    rt = RuntimeConfig(max_points=max_points, capacity_level0=cap0,
                       capacity_decay=0.5, min_capacity=min_cap, sigma=0.6)
    caps = rt.capacities(2)

    worst = [0] * len(caps)
    windows = []
    with tempfile.TemporaryDirectory() as root:
        for w in range(args.worlds):
            write_moving_world(root, f"{w:02d}", args.scans, beams, n_az,
                               bool(args.moving), seed=1000 + w)
        lc = dict(dataset_path=root, include_moving_classes=True,
                  frames_per_seq=4, cloud_scope=1, do_pose=True,
                  shuffle_points=False, measure_sequence_lengths=True,
                  transformer={})
        ds = SemanticKittiDataset("train", lc, {}, sequence_learning=True,
                                  max_points=max_points)
        for i in range(0, len(ds), args.stride):
            frames = ds[i]
            counts = union_counts(np.stack([f.positions for f in frames]),
                                  np.stack([f.mask for f in frames]), rt,
                                  caps, device)
            worst = [max(a, b) for a, b in zip(worst, counts)]
            windows.append(counts)
            print(f"window {i + 1}/{len(ds)}: counts {counts}", flush=True)
    print(f"\nscale={args.scale} moving={args.moving} caps={list(caps)}")
    print("worst-case union counts:", worst,
          " fill:", [f"{w / c:.2f}" for w, c in zip(worst, caps)])
    return {"scale": args.scale, "moving": args.moving, "caps": list(caps),
            "worst": worst, "windows": windows}


if __name__ == "__main__":
    main()
