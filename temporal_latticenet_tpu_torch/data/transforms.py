"""Sequence-consistent data augmentation, NumPy host-side (a copy of the
JAX package's: the same draws in the same order).

Re-creates ``DataTransformer`` (upstream DataTransformer.py:55-157):
one random draw per *sequence*, applied identically to every frame, so the
temporal alignment between scans is preserved.  Train-split only; the
hsv-jitter and xyz-noise knobs are parsed but no-ops, as in the reference
(:146-152).
"""

from __future__ import annotations

import numpy as np


def rotation_matrix(angle_deg: float, axis: str) -> np.ndarray:
    """4x4 homogeneous rotation (DataTransformer.py:19-31)."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    r = np.eye(3)
    if axis == "x":
        r = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == "y":
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    elif axis == "z":
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    else:
        raise ValueError("axis must be x, y or z")
    T = np.eye(4)
    T[:3, :3] = r
    return T


def load_velo_to_cam_transform() -> np.ndarray:
    """KITTI calib_velo_to_cam constants (DataTransformer.py:10-16)."""
    T = np.eye(4)
    T[:3, :3] = np.array([
        [7.533745e-03, -9.999714e-01, -6.166020e-04],
        [1.480249e-02, 7.280733e-04, -9.998902e-01],
        [9.998621e-01, 7.523790e-03, 1.480755e-02]])
    T[:3, 3] = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])
    return T


class DataTransformer:
    """Config keys mirror the ``transformer:`` cfg section
    (lnn_train_semantic_kitti.cfg:119-134)."""

    def __init__(self, transformer_config: dict, split: str = "train",
                 rng: np.random.Generator | None = None):
        c = transformer_config
        self.translation_xyz = c.get("random_translation_xyz_magnitude", 0.0)
        self.translation_xz = c.get("random_translation_xz_magnitude", 0.0)
        self.rotation_y_max = c.get("rotation_y_max_angle", 0.0)
        self.stretch_xyz = c.get("random_stretch_xyz_magnitude", 0.0)
        self.subsample_pct = c.get("random_subsample_percentage", 0.0)
        self.mirror_x = c.get("random_mirror_x", False)
        self.mirror_z = c.get("random_mirror_z", False)
        self.rot90_y = c.get("random_rotation_90_degrees_y", False)
        self.split = split
        self.rng = rng or np.random.default_rng()

    def transform(self, clouds: list[np.ndarray],
                  extras: list[list[np.ndarray]] | None = None):
        """Augment a sequence of (N_i, 3) clouds with ONE random draw.

        ``extras`` (optional): per-frame lists of per-point arrays (labels,
        reflectance) kept aligned under subsampling.
        """
        if self.split != "train":
            return clouds, extras
        rng = self.rng

        if self.subsample_pct != 0.0:
            for i in range(len(clouds)):
                keep = rng.random(clouds[i].shape[0]) >= self.subsample_pct
                clouds[i] = clouds[i][keep]
                if extras is not None:
                    extras[i] = [e[keep] for e in extras[i]]

        if self.translation_xyz != 0.0:
            t = rng.random(3) * self.translation_xyz
            clouds = [c + t for c in clouds]

        if self.translation_xz != 0.0:
            t = rng.random(3) * self.translation_xz
            t[1] = 0.0
            clouds = [c + t for c in clouds]

        if self.stretch_xyz != 0.0:
            s = 1.0 + rng.uniform(-self.stretch_xyz, self.stretch_xyz)
            f = np.array([1.0 + rng.uniform(-s, s) for _ in range(3)])
            clouds = [c * f for c in clouds]

        if self.rotation_y_max != 0.0:
            ang = rng.uniform(-self.rotation_y_max / 2, self.rotation_y_max / 2)
            r = rotation_matrix(ang, "y")[:3, :3]
            clouds = [c @ r.T for c in clouds]

        if self.mirror_x and rng.random() < 0.5:
            for c in clouds:
                c[:, 0] = -c[:, 0]

        if self.mirror_z and rng.random() < 0.5:
            for c in clouds:
                c[:, 2] = -c[:, 2]

        if self.rot90_y:
            r = rotation_matrix(90.0 * rng.integers(0, 4), "y")[:3, :3]
            clouds = [c @ r.T for c in clouds]

        return clouds, extras
