"""Per-level lattice occupancy of the benchmark generators.

Prints each level's union count after every frame of a 4-frame sequence
for the legacy synthetic generator and the ray-cast LiDAR simulator, and
the fill against the capacities, to size honest static capacities.  On
the card the lattice build runs K1-K3.

    python -m temporal_latticenet_tpu_torch.experiments.occupancy \\
        [--points 120000] [--capacity 98304] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import RuntimeConfig
from ..data.lidar_like import lidar_sequence
from ..data.synthetic import synthetic_sequence
from ..device import resolve_device
from ..ops import seq_lattice as sl


def measure(name, p, m, caps, sigma, nr_downsamples, device) -> list:
    """Each level's per-frame union counts (slot 0 included)."""
    with torch.no_grad():
        lat = sl.build_sequence_lattice(
            torch.as_tensor(p, device=device),
            torch.as_tensor(m, device=device), sigma, caps, nr_downsamples)
    print(f"\n{name}: points/frame={int(m.sum(1)[0])} (mask), caps={caps}")
    out = []
    for lvl_i, lvl in enumerate(lat.levels):
        counts = lvl.counts.cpu().tolist()
        out.append(counts)
        print(f"  level {lvl_i}: per-frame counts {counts} "
              f"(cap {caps[lvl_i]}, fill {counts[-1] / caps[lvl_i]:.2f})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=120_000)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=98_304)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    max_pts = 131072
    # decay 0.5: the capacities the benchmark and the shipped runtime
    # configs run with (fill ratios are against real capacities)
    rt = RuntimeConfig(max_points=max_pts, capacity_level0=args.capacity,
                       capacity_decay=0.5, min_capacity=8192, sigma=0.6)
    caps = rt.capacities(2)

    rng = np.random.default_rng(0)
    p, v, l, m = synthetic_sequence(rng, args.frames, args.points, max_pts)
    synthetic = measure("synthetic (legacy bench)", p, m, caps, rt.sigma, 2,
                        device)

    rng = np.random.default_rng(0)
    p, v, l, m = lidar_sequence(rng, args.frames, max_pts)
    lidar = measure("lidar_like (ray-cast)", p, m, caps, rt.sigma, 2, device)
    return {"caps": list(caps), "synthetic": synthetic, "lidar_like": lidar}


if __name__ == "__main__":
    main()
