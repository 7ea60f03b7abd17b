"""The port's accuracy experiments on the card, with their measurements.

    python scripts/torch_lidar_experiments.py --out-dir <dir> \\
        [--variants temporal,static,accum] [--occupancy] [--float32] \\
        [--root <dir>] [--data <dir>] \\
        -- <train_lidar flags, e.g. --moving 1 --scale full --worlds 10
            --scans 10 --epochs 16 --scope 1 [--seed N]>

Runs ``experiments.train_lidar`` once per variant with the flags after
``--``, all variants on one set of worlds under ``--root`` (default
``build/lidar_<scale>_m<moving>``), each under ``chip_smoke``'s
``ExperimentProbe``: the seconds of every training step (host clock), each
kernel's launches per step, each epoch's mean loss, peak memory and the
loader's seconds per window.  It writes ``<dir>/moving_<variant>_<scale>.json``
(``lidar_<variant>_m<moving>_<scale>.json`` without moving actors),
``<dir>/measure_<variant>.json`` (with each epoch's valid IoUs), and with
moving actors the comparison
table (``experiments.moving_table``).  ``--occupancy`` first probes the
worlds' worst-case union counts (``experiments.occupancy_worlds``, every
window) against the scale's capacities.  ``--float32`` adds
``compute_dtype: "float32"`` to the cfg's ``runtime`` section (the per-frame
pointnet route, no K4).  ``--data`` links ``<root>/data`` to worlds already
written there, so that runs side by side (other seeds, other roots) share
one set of worlds.  The card's name and power limit are in every
measurement file.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from temporal_latticenet_tpu_torch.experiments import (  # noqa: E402
    moving_table, occupancy_worlds, train_lidar)
from temporal_latticenet_tpu_torch.ops import _cuda  # noqa: E402


# moving-car and moving-person (train_lidar.CLASS_NAMES)
MOVING_IDS = (20, 22)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" in argv:
        i = argv.index("--")
        argv, passthrough = argv[:i], argv[i + 1:]
    else:
        passthrough = []
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--variants", default="temporal,static,accum")
    ap.add_argument("--root", default="")
    ap.add_argument("--occupancy", action="store_true")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--data", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lidar_experiments: needs CUDA", file=sys.stderr)
        return 2

    flags = train_lidar.parse_args(passthrough)
    os.makedirs(args.out_dir, exist_ok=True)
    root = args.root or os.path.join(
        ROOT, "build", f"lidar_{flags.scale}_m{flags.moving}")
    if args.float32:
        train_lidar.CFG_TEMPLATE = train_lidar.CFG_TEMPLATE.replace(
            'remat_mode: "{remat}"',
            'remat_mode: "{remat}"\n    compute_dtype: "float32"')
    if args.data:
        os.makedirs(root, exist_ok=True)
        link = os.path.join(root, "data")
        if not os.path.lexists(link):
            os.symlink(os.path.abspath(args.data), link)
    dline = chip_smoke.device_line()
    print(dline, flush=True)
    print(json.dumps(_cuda.build()), flush=True)

    if args.occupancy:
        t0 = time.perf_counter()
        occ = occupancy_worlds.main(
            ["--scale", flags.scale, "--moving", str(flags.moving),
             "--worlds", str(flags.worlds), "--scans", str(flags.scans),
             "--stride", "1"])
        occ.update(seconds=time.perf_counter() - t0, device=dline)
        with open(os.path.join(args.out_dir, "occupancy_worlds.json"),
                  "w") as f:
            json.dump(occ, f, indent=1)

    for v in args.variants.split(","):
        name = (f"moving_{v}_{flags.scale}" if flags.moving
                else f"lidar_{v}_m{flags.moving}_{flags.scale}")
        out = os.path.join(args.out_dir, name + ".json")
        run = chip_smoke.measured_run(
            train_lidar.main,
            passthrough + ["--variant", v, "--root", root, "--out", out],
            os.path.join(root, f"cfg_{v}.cfg"))
        run.update(device=dline, float32=args.float32)
        with open(os.path.join(args.out_dir, f"measure_{v}.json"), "w") as f:
            json.dump(run, f, indent=1)
        print(f"[{v}] {run['steps']} steps, {run['seconds_per_step']:.4f} "
              f"s/step (quartiles {run['quartiles']}), loader "
              f"{run['loader_s_per_window']:.4f} s/window, peak "
              f"{run['peak_mem_gb']:.2f} GB, launches per step "
              f"{run['launches_per_step_min']} - "
              f"{run['launches_per_step_max']}, valid mIoU "
              f"{run['results']['miou_valid']:.4f} on {dline}", flush=True)
        for e in run["valid_epochs"]:
            moving = [e["iou"].get(c, 0.0) for c in MOVING_IDS]
            print(f"[{v}] epoch {e['epoch']} valid mIoU {e['miou']:.4f}, "
                  f"moving mean {sum(moving) / 2:.4f}", flush=True)
    if flags.moving:
        moving_table.main([flags.scale, "--dir", args.out_dir])
    return 0


if __name__ == "__main__":
    sys.exit(main())
