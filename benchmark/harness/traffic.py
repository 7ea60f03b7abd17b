"""The general generator: a traffic mix's parameters (a JSON file under
``benchmark/traffic/``) -> a pool of LiDAR sequences drawn from the seed.

Each sequence comes from its own ray-cast world (``lidar_like``, the
frozen copy), its frames ``cloud_scope`` scans apart (the configuration's
``data`` section): the sensor moves ``scan_motion_m`` a scan.  Every frame is then cut to exactly ``points_per_frame`` real
returns, drawn from the seed, and padded to the configuration's
``max_points`` rows, so that every seed gives the same amount of work.  A
world whose frames return fewer points is drawn again.
"""

from __future__ import annotations

import numpy as np

from .lidar_like import lidar_sequence


def make_pool(gen: dict, pool: int, frames: int, max_points: int,
              cloud_scope: int = 1):
    """Returns numpy arrays (pool, T, P, 3) positions, (pool, T, P, 1)
    values, (pool, T, P) int64 labels and (pool, T, P) bool mask, drawn
    from the mix's ``world_seed``: the same pool in every run, so that every
    seed gives the same work (the run's seed orders it)."""
    rng = np.random.default_rng(gen["world_seed"])
    n_beams, n_az = gen["n_beams"], gen["n_az"]
    keep = gen["points_per_frame"]
    if keep > max_points:
        raise ValueError(f"points_per_frame {keep} > max_points {max_points}")
    out = (np.zeros((pool, frames, max_points, 3), np.float32),
           np.zeros((pool, frames, max_points, 1), np.float32),
           np.zeros((pool, frames, max_points), np.int64),
           np.zeros((pool, frames, max_points), bool))
    k = 0
    while k < pool:
        p, v, l, m = lidar_sequence(
            rng, frames=frames, max_points=n_beams * n_az, n_beams=n_beams,
            n_az=n_az, speed=gen["scan_motion_m"] * cloud_scope,
            moving_cars=gen.get("moving_cars", 0),
            moving_peds=gen.get("moving_peds", 0))
        counts = m.sum(axis=1)
        if counts.min() < keep:
            continue
        for t in range(frames):
            sel = np.sort(rng.choice(int(counts[t]), keep, replace=False))
            out[0][k, t, :keep] = p[t, sel]
            out[1][k, t, :keep] = v[t, sel]
            out[2][k, t, :keep] = l[t, sel]
            out[3][k, t, :keep] = True
        k += 1
    return out
