"""A cell of ``BENCHMARK.json`` cut to a size that a CPU test run holds:
the configuration's widths and depth as they are, 1,024 padded points a
frame from 16 beams x 64 azimuths, capacities 16384/8192/8192, a pool of 2.
"""

from __future__ import annotations

import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_RUNTIME = {"max_points": 1024, "capacity_level0": 16384,
                 "min_capacity": 8192}
SMALL_GENERATOR = {"n_beams": 16, "n_az": 64, "points_per_frame": 800}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(workload: str):
    """(spec, config, traffic, limits) of ``workload`` at the small size."""
    s = spec()
    wl = {w["name"]: w for w in s["workloads"]}[workload]
    conf = {c["name"]: c for c in s["configs"]}[wl["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    config["runtime"].update(SMALL_RUNTIME)
    with open(os.path.join(BENCH, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    traffic["pool"] = max(2, traffic.get("check_steps", 0))
    traffic["generator"].update(SMALL_GENERATOR)
    from harness.check import limits
    return s, config, traffic, limits(BENCH, workload)


def run(workload: str, seed: int = 7, seconds: float = 0.2, limits=None):
    """One run of the small cell on the CPU (the harness's look for a chip
    skipped); returns the result line's object."""
    import torch
    from harness.core import run_cell
    s, config, traffic, lims = cell(workload)
    torch.manual_seed(0)
    return run_cell(BENCH, s, workload, config, traffic,
                    lims if limits is None else limits, seed, seconds, 0,
                    torch.device("cpu"), time.perf_counter())
