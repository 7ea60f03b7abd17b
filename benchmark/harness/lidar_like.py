"""Frozen copy of the port's ``data/lidar_like.py``, the benchmark's scan
generator (``harness/traffic.py`` drives it; later changes to the port's
copy cannot move the benchmark's inputs).

Ray-cast spinning-LiDAR simulator: realistic scan geometry for benchmarks
and overfit/accuracy runs when no SemanticKITTI blob is available.

Reproduces the scan statistics that drive lattice occupancy and gather
locality:

* ring structure: B beams at fixed elevation angles (HDL-64E-like, +2 deg to
  -24.8 deg) times an azimuth sweep -> concentric ground rings whose spacing
  grows with range;
* range-dependent density: returns cluster near the sensor; upward beams and
  >80 m rays produce NO return (variable per-scan point count, padded);
* vertical structures: procedurally placed cylinders (buildings, trunks,
  poles, cars) occlude the ground and paint vertical stripes;
* sequential pose drift: the sensor translates ~1 m/frame with slight yaw,
  and all frames are re-expressed in the FIRST frame's sensor coordinates --
  the same alignment the SemanticKITTI loader performs
  (the upstream project's kitti_dataloader.py).

Labels are deterministic functions of the geometry (ground / building /
trunk / pole / car), so a model can genuinely overfit to high mIoU --
unlike the random labels of ``data/synthetic.py``.
"""

from __future__ import annotations

import numpy as np

# class ids chosen inside the 20-class SemanticKITTI training-label range
CLASS_UNLABELED = 0
CLASS_GROUND = 9       # "road" slot
CLASS_BUILDING = 13
CLASS_TRUNK = 16
CLASS_POLE = 18
CLASS_CAR = 1
CLASS_PERSON = 6

# moving-class ids of the 26-class "all" setting
# (the upstream semantic-kitti-all.yaml learning map: a moving
# object keeps its geometry class but shifts to the moving id)
CLASS_MOVING_CAR = 20
CLASS_MOVING_PERSON = 22

SENSOR_HEIGHT = 1.73   # m, HDL-64E mount height on the KITTI car
MAX_RANGE = 80.0


def material_class(lbl: np.ndarray) -> np.ndarray:
    """Collapse moving ids onto the material of their static counterpart
    (20 -> 1 car, 22 -> 6 person) for appearance-like channels."""
    return np.where(lbl == CLASS_MOVING_CAR, CLASS_CAR,
                    np.where(lbl == CLASS_MOVING_PERSON, CLASS_PERSON, lbl))


def _make_world(rng: np.random.Generator, radius: float = 90.0,
                include_cars: bool = True):
    """Procedural world: vertical cylinders with a type-dependent size.

    ``include_cars=False`` drops the background car population: the
    moving-class experiment needs EVERY car drawn from the actor spawn
    distribution (movers and parked counterparts alike), otherwise the
    distribution difference — background cars spread over the full radius
    and excluded from the ego corridor, actors central — hands a
    single-frame model a spatial prior on moving-vs-static (observed:
    a frames=1 model scored 0.54 valid IoU on moving-car by exploiting
    exactly this before the fix).
    """
    specs = [
        # (count, r_lo, r_hi, h_lo, h_hi, class)
        (24, 3.0, 8.0, 5.0, 15.0, CLASS_BUILDING),
        (30, 0.15, 0.45, 2.0, 8.0, CLASS_TRUNK),
        (20, 0.05, 0.15, 3.0, 7.0, CLASS_POLE),
    ]
    if include_cars:
        specs.append((26, 0.8, 1.3, 1.2, 1.8, CLASS_CAR))
    centers, radii, heights, classes = [], [], [], []
    for count, r_lo, r_hi, h_lo, h_hi, cls in specs:
        c = (rng.random((count, 2)) - 0.5) * 2 * radius
        # keep a clear corridor along +x so the ego-path stays drivable
        c[:, 1] = np.where(np.abs(c[:, 1]) < 4.0, c[:, 1] + 8.0, c[:, 1])
        centers.append(c)
        radii.append(rng.uniform(r_lo, r_hi, count))
        heights.append(rng.uniform(h_lo, h_hi, count))
        classes.append(np.full(count, cls, np.int32))
    return (np.concatenate(centers).astype(np.float32),
            np.concatenate(radii).astype(np.float32),
            np.concatenate(heights).astype(np.float32),
            np.concatenate(classes))


def _make_actors(rng: np.random.Generator, n_cars: int, n_peds: int):
    """Dynamic actors: cylinders that translate between frames.

    A moving actor's per-frame GEOMETRY is indistinguishable from its static
    counterpart (same radius/height distributions as _make_world's cars, and
    person-sized cylinders); only its motion across frames separates class
    1/6 from 20/22.  This is the controlled test of the paper's moving-class
    claim (README.md:13; the 26-class setting of
    the upstream semantic-kitti-all.yaml): a single-frame model
    cannot beat the class prior on moving-vs-static, a temporal model can.

    Actors spawn near the ego corridor (within ~35 m) so they receive dense
    returns, and move 0.6-2.2 m/frame (cars) / 0.15-0.5 m/frame (peds) --
    several lattice cells at sigma 0.6.
    """
    specs = [
        (n_cars, 0.8, 1.3, 1.2, 1.8, 0.6, 2.2, CLASS_MOVING_CAR),
        (n_peds, 0.25, 0.4, 1.5, 1.9, 0.15, 0.5, CLASS_MOVING_PERSON),
    ]
    centers, radii, heights, classes, vels = [], [], [], [], []
    for count, r_lo, r_hi, h_lo, h_hi, s_lo, s_hi, cls in specs:
        c = (rng.random((count, 2)) - 0.5) * np.array([70.0, 50.0])
        centers.append(c)
        radii.append(rng.uniform(r_lo, r_hi, count))
        heights.append(rng.uniform(h_lo, h_hi, count))
        classes.append(np.full(count, cls, np.int32))
        ang = rng.random(count) * 2 * np.pi
        spd = rng.uniform(s_lo, s_hi, count)
        vels.append(np.stack([np.cos(ang), np.sin(ang)], 1) * spd[:, None])
    return (np.concatenate(centers).astype(np.float32),
            np.concatenate(radii).astype(np.float32),
            np.concatenate(heights).astype(np.float32),
            np.concatenate(classes),
            np.concatenate(vels).astype(np.float32))


def _static_counterparts(rng: np.random.Generator, n_cars: int, n_peds: int,
                         smear_scans: int = 0):
    """Parked cars / standing pedestrians with the same geometry and spawn
    distributions as the movers, so motion is the ONLY separating signal.

    ``smear_scans > 0`` displaces each counterpart by ``v * u`` with a
    mover-distributed velocity ``v`` and ``u ~ U[0, smear_scans)``: the
    counterparts' spatial distribution then matches the movers' marginal
    over the episode, not just their scan-0 spawn (movers spread as they
    travel; un-smeared counterparts would stay tight, a weak single-frame
    position cue)."""
    c, r, h, cls, v = _make_actors(rng, n_cars, n_peds)
    if smear_scans:
        u = rng.uniform(0.0, smear_scans, len(c)).astype(np.float32)
        c = c + v * u[:, None]
    cls = np.where(cls == CLASS_MOVING_CAR, CLASS_CAR, CLASS_PERSON)
    return c, r, h, cls.astype(np.int32)


def _raycast_scan(world, sensor_xy, yaw, n_beams, n_az,
                  rng: np.random.Generator):
    """One scan from ``sensor_xy``: returns (points (N,3), labels (N,)) in
    SENSOR coordinates (z up, sensor at origin at SENSOR_HEIGHT)."""
    centers, radii, heights, classes = world

    elev = np.deg2rad(np.linspace(2.0, -24.8, n_beams)).astype(np.float32)
    az = (np.linspace(0, 2 * np.pi, n_az, endpoint=False) + yaw
          ).astype(np.float32)

    # horizontal cylinder intersections are elevation-independent: solve the
    # 2D ray-circle quadratic once per (azimuth, structure)
    dx, dy = np.cos(az), np.sin(az)                     # (A,)
    rel = centers - np.asarray(sensor_xy, np.float32)   # (K, 2)
    b = dx[:, None] * rel[None, :, 0] + dy[:, None] * rel[None, :, 1]  # (A,K)
    c = (rel ** 2).sum(1)[None, :] - (radii ** 2)[None, :]
    disc = b * b - c
    hit = (disc > 0) & (b > 0)
    t_xy = np.where(hit, b - np.sqrt(np.maximum(disc, 0)), np.inf)     # (A,K)
    t_xy = np.where(t_xy > 0, t_xy, np.inf)

    # two nearest candidate structures per azimuth (a tall far wall can be
    # occluded low and visible high; two candidates cover the common case)
    k1 = np.argmin(t_xy, axis=1)                        # (A,)
    cols = np.arange(t_xy.shape[0])
    t1 = t_xy[cols, k1]
    t_xy2 = t_xy.copy()
    t_xy2[cols, k1] = np.inf
    k2 = np.argmin(t_xy2, axis=1)
    t2 = t_xy2[cols, k2]

    tan_e = np.tan(elev)[:, None]                       # (B, 1)
    cos_e = np.cos(elev)[:, None]

    def wall_hit(t_cand, k_cand):
        z = SENSOR_HEIGHT + t_cand[None, :] * tan_e     # (B, A) z at the wall
        ok = (z >= 0.0) & (z <= heights[k_cand][None, :]) \
            & np.isfinite(t_cand)[None, :] & (t_cand[None, :] < MAX_RANGE)
        return ok, z

    ok1, z1 = wall_hit(t1, k1)
    ok2, z2 = wall_hit(t2, k2)

    # ground hit for downward beams, blocked by any wall that is closer
    t_ground = np.where(tan_e < -1e-4, SENSOR_HEIGHT / np.maximum(-tan_e, 1e-6),
                        np.inf)                          # (B, 1)
    t_ground = np.broadcast_to(t_ground, ok1.shape)
    blocked1 = ok1 & (t1[None, :] < t_ground)
    blocked2 = ok2 & (t2[None, :] < t_ground)
    ground_ok = (t_ground < MAX_RANGE) & ~blocked1 & ~blocked2

    # resolve: nearest of {wall1, wall2, ground}
    t_w1 = np.where(ok1, t1[None, :], np.inf)
    t_w2 = np.where(ok2, t2[None, :], np.inf)
    t_g = np.where(ground_ok, t_ground, np.inf)
    t_all = np.stack([t_w1, t_w2, t_g])                 # (3, B, A)
    which = np.argmin(t_all, axis=0)
    t_hit = np.take_along_axis(t_all, which[None], 0)[0]
    has = np.isfinite(t_hit)

    lbl = np.where(which == 2, CLASS_GROUND,
                   np.where(which == 0, classes[k1][None, :],
                            classes[k2][None, :])).astype(np.int32)

    # assemble 3D points with ~2 cm range noise; inf ranges (misses) are
    # multiplied through harmlessly and dropped by the `has` mask below
    t_hit = t_hit + rng.standard_normal(t_hit.shape).astype(np.float32) * 0.02
    with np.errstate(invalid="ignore", over="ignore"):
        x = t_hit * dx[None, :]
        y = t_hit * dy[None, :]
        z = SENSOR_HEIGHT + t_hit * tan_e - SENSOR_HEIGHT  # sensor at origin
        pts = np.stack([x, y, z], axis=-1).astype(np.float32)

    keep = has.reshape(-1)
    return pts.reshape(-1, 3)[keep], lbl.reshape(-1)[keep]


def lidar_sequence(rng: np.random.Generator, frames: int, max_points: int,
                   n_beams: int = 64, n_az: int = 2048,
                   speed: float = 1.0, world_seed: int | None = None,
                   moving_cars: int = 0, moving_peds: int = 0):
    """Simulate a ``frames``-long sequence; returns (positions, values,
    labels, mask) stacked (T, P, ...) in FRAME-0 sensor coordinates.

    ``n_beams * n_az`` rays/scan (default 131072); real return counts come
    out lower (sky rays, >80 m) -- typically ~105-120k, like SemanticKITTI.

    ``moving_cars``/``moving_peds`` > 0 adds dynamic actors (ids 20/22 of
    the 26-class setting) plus an equal number of geometrically identical
    STATIC counterparts (ids 1/6), making motion the only separating signal
    between the static and moving variants of a class.
    """
    wrng = rng if world_seed is None else np.random.default_rng(world_seed)
    moving = bool(moving_cars or moving_peds)
    world = _make_world(wrng, include_cars=not moving)
    actors = None
    if moving:
        actors = _make_actors(wrng, moving_cars, moving_peds)
        sc, sr, sh, scls = _static_counterparts(wrng, moving_cars,
                                                moving_peds,
                                                smear_scans=frames)
        world = (np.concatenate([world[0], sc]),
                 np.concatenate([world[1], sr]),
                 np.concatenate([world[2], sh]),
                 np.concatenate([world[3], scls]))

    out_p = np.zeros((frames, max_points, 3), np.float32)
    out_v = np.zeros((frames, max_points, 1), np.float32)
    out_l = np.zeros((frames, max_points), np.int32)
    out_m = np.zeros((frames, max_points), bool)

    yaw0 = float(rng.random() * 2 * np.pi)
    for t in range(frames):
        sensor_xy = np.array([speed * t, 0.02 * t], np.float32)
        yaw = yaw0 + 0.01 * t
        frame_world = world
        if actors is not None:
            ac, ar, ah, acls, av = actors
            frame_world = (np.concatenate([world[0], ac + av * t]),
                           np.concatenate([world[1], ar]),
                           np.concatenate([world[2], ah]),
                           np.concatenate([world[3], acls]))
        pts, lbl = _raycast_scan(frame_world, sensor_xy, yaw, n_beams, n_az,
                                 rng)
        # to frame-0 coordinates (translation only; yaw is the scan's own
        # sweep phase, the platform does not rotate here)
        pts = pts + np.array([sensor_xy[0], sensor_xy[1], 0.0], np.float32)

        n = min(len(pts), max_points)
        sel = (np.arange(n) if len(pts) <= max_points
               else rng.choice(len(pts), max_points, replace=False))
        out_p[t, :n] = pts[sel][:n]
        # reflectance: MATERIAL-dependent mean + noise.  A moving actor has
        # the same material as its static counterpart (moving-car looks like
        # car, moving-person like person) -- otherwise reflectance would leak
        # the moving/static distinction to a single-frame model and defeat
        # the temporal-evidence experiment.
        mat = material_class(lbl[sel][:n])
        refl = (0.1 + 0.08 * (mat % 7)
                + 0.05 * rng.standard_normal(n)).astype(np.float32)
        out_v[t, :n, 0] = np.clip(refl, 0.0, 1.0)
        out_l[t, :n] = lbl[sel][:n]
        out_m[t, :n] = True
    return out_p, out_v, out_l, out_m
