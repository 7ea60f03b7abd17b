"""Synthetic LiDAR-like sequences (a copy of the JAX package's).

Generates clouds with the statistics that matter for the lattice pipeline:
~100k points on a quasi-2D ground-plus-structures manifold (so vertex counts
per scan match real SemanticKITTI at sigma 0.6, ~20-40k occupied vertices),
with small inter-frame ego-motion.
"""

from __future__ import annotations

import numpy as np


def lidar_like_cloud(rng: np.random.Generator, n_points: int,
                     radius: float = 50.0) -> np.ndarray:
    """One scan: ground disc + random vertical structures + canopy noise."""
    n_ground = n_points // 2
    n_walls = n_points // 3
    n_scatter = n_points - n_ground - n_walls

    # ground: denser near the sensor, like real spinning-lidar returns
    r = radius * np.sqrt(rng.random(n_ground)) * rng.random(n_ground)
    th = rng.random(n_ground) * 2 * np.pi
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       0.05 * rng.standard_normal(n_ground)], 1)

    # vertical structures at random placements
    n_struct = 40
    centers = (rng.random((n_struct, 2)) - 0.5) * 2 * radius
    wi = rng.integers(0, n_struct, n_walls)
    walls = np.stack([
        centers[wi, 0] + rng.standard_normal(n_walls) * 1.5,
        centers[wi, 1] + rng.standard_normal(n_walls) * 1.5,
        rng.random(n_walls) * 6.0,
    ], 1)

    scatter = np.stack([
        (rng.random(n_scatter) - 0.5) * 2 * radius,
        (rng.random(n_scatter) - 0.5) * 2 * radius,
        rng.random(n_scatter) * 8.0,
    ], 1)
    return np.concatenate([ground, walls, scatter]).astype(np.float32)


def synthetic_sequence(rng: np.random.Generator, frames: int, n_points: int,
                       max_points: int, nr_classes: int = 26):
    """Returns stacked (T, P, ...) numpy arrays: positions, values, labels,
    mask.  Frames share most structure with per-frame ego-motion drift,
    exercising the growing-lattice temporal path like real sequences."""
    base = lidar_like_cloud(rng, n_points)
    out_p = np.zeros((frames, max_points, 3), np.float32)
    out_v = np.zeros((frames, max_points, 1), np.float32)
    out_l = np.zeros((frames, max_points), np.int32)
    out_m = np.zeros((frames, max_points), bool)
    labels = 1 + (rng.random(n_points) * (nr_classes - 1)).astype(np.int32)
    for t in range(frames):
        drift = np.array([0.8 * t, 0.1 * t, 0.0], np.float32)
        jitter = rng.standard_normal((n_points, 3)).astype(np.float32) * 0.02
        n = min(n_points, max_points)
        out_p[t, :n] = (base + drift + jitter)[:n]
        out_v[t, :n] = rng.random((n, 1)).astype(np.float32)
        out_l[t, :n] = labels[:n]
        out_m[t, :n] = True
    return out_p, out_v, out_l, out_m
