"""SemanticKITTI sequence dataset: host-side NumPy pipeline feeding padded,
device-ready frame batches.

Re-creates ``SemanticKittiDataset`` (upstream dataloader/kitti_dataloader.py:21-201)
byte-for-byte in behaviour:

* sequence windows ``[-(F-1)*scope, ..., -scope, 0] + idx`` clamped >= 0,
  located through the cumulative official per-sequence scan counts (:100-118);
* pose alignment of all frames into the frame of the window's FIRST scan via
  ``poses.txt`` + ``calib.txt`` (:122,159-167), then a -90 deg x-rotation to
  z-up (:166,169);
* train-only cap/min distance filters (:142-154) and point shuffling
  (:175-180); reflectance features or ones (:183-186);
* debug fixtures: ``do_overfit``/``overfit_num_clouds``, ``debug_loader``
  (labels replaced by frame index), ``seq_same_cloud`` (:54-68,91-102);
* ``accumulate_clouds`` concatenates the window into one cloud (:198-201).

``pad_frame`` pads points to a static ``max_points`` with a validity mask
(replacing the reference's dynamic shapes), so every sequence has the
shapes the static lattice capacities are sized for.  A copy of the JAX
package's ``data/kitti.py``: the same windows and the same draws of the
random generator, so one seed gives the same items.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import kitti_meta
from .transforms import DataTransformer, load_velo_to_cam_transform, rotation_matrix


def parse_calibration(filename: str) -> dict:
    """calib.txt -> {key: 4x4} (kitti_dataloader.py:205-229)."""
    calib = {}
    with open(filename) as f:
        for line in f:
            key, content = line.strip().split(":")
            vals = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = vals[0:4]
            pose[1, :4] = vals[4:8]
            pose[2, :4] = vals[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def parse_poses(filename: str, calibration: dict) -> list:
    """poses.txt -> list of velodyne-to-world 4x4 (kitti_dataloader.py:231-258)."""
    tr = calibration["Tr"]
    tr_inv = np.linalg.inv(tr)
    poses = []
    with open(filename) as f:
        for line in f:
            vals = [float(v) for v in line.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = vals[0:4]
            pose[1, :4] = vals[4:8]
            pose[2, :4] = vals[8:12]
            pose[3, 3] = 1.0
            poses.append(tr_inv @ pose @ tr)
    return poses


def load_label(path: str, remap_lut: np.ndarray) -> np.ndarray:
    """.label file -> remapped training labels (kitti_dataloader.py:281-291:
    lower 16 bits are the semantic label, upper 16 the instance id)."""
    raw = np.fromfile(path, dtype=np.uint32)
    sem = (raw & 0xFFFF).astype(np.int32)
    return remap_lut[sem]


@dataclass
class FrameBatch:
    """One padded frame, ready for device transfer."""

    positions: np.ndarray   # (P, 3) f32
    values: np.ndarray      # (P, V) f32
    labels: np.ndarray      # (P,) int32
    mask: np.ndarray        # (P,) bool
    n_points: int
    path: str
    last_n: int = -1        # points of the LAST scan (== n_points unless
                            # accumulate_clouds concatenated several scans);
                            # submission writing trims to the final last_n
                            # rows (test_ln.py:221's l_pred[-len_seq[-1]:])

    def __post_init__(self):
        if self.last_n < 0:
            object.__setattr__(self, "last_n", self.n_points)


def pad_frame(positions, values, labels, max_points, path="",
              last_n: int = -1) -> FrameBatch:
    n = positions.shape[0]
    if n > max_points:
        # static capacity exceeded: keep the first max_points (points are
        # shuffled during training; for eval raise the runtime capacity)
        positions, values, labels = (positions[:max_points], values[:max_points],
                                     labels[:max_points])
        n = max_points
    p = np.zeros((max_points, 3), np.float32)
    v = np.zeros((max_points, values.shape[1]), np.float32)
    l = np.zeros((max_points,), np.int32)
    p[:n] = positions
    v[:n] = values
    l[:n] = labels
    mask = np.arange(max_points) < n
    return FrameBatch(p, v, l, mask, n, path,
                      min(last_n, n) if last_n >= 0 else n)


class SemanticKittiDataset:
    """Iterable dataset of pose-aligned scan sequences.

    Args mirror the reference constructor (split, config sections); the
    config is the ``loader_semantic_kitti`` dict of the .cfg file.
    """

    def __init__(self, split: str, loader_config: dict, model_config: dict,
                 sequence_learning: bool, max_points: int = 131072,
                 seed: int | None = None, use_native: bool = True):
        lc = loader_config
        self.use_native = use_native
        self.split = split
        self.data_dir = lc["dataset_path"]
        self.include_moving = lc.get("include_moving_classes", False)
        self.remap_lut = kitti_meta.build_remap_lut(self.include_moving)
        self.split_seqs = kitti_meta.SPLIT
        self.dataset_lengths = list(kitti_meta.SPLIT_LENGTHS[split])
        if lc.get("measure_sequence_lengths", False):
            # count scans actually on disk instead of trusting the official
            # SPLIT_LENGTHS table (kitti_dataloader.py:49's hardcoded
            # counts).  Needed for synthetic/partial datasets: with the
            # official lengths a small nr_clouds_to_read maps every index
            # into sequence 00 and the remaining sequences are never read.
            self.dataset_lengths = []
            for s in self.split_seqs[split]:
                d = os.path.join(self.data_dir, "sequences", f"{int(s):02d}",
                                 "velodyne")
                self.dataset_lengths.append(
                    len([f for f in os.listdir(d) if f.endswith(".bin")])
                    if os.path.isdir(d) else 0)

        self.nr_clouds_to_read = lc.get("nr_clouds_to_read", -1)
        self.nr_clouds_to_skip = lc.get("nr_clouds_to_skip", 0)
        self.do_overfit = lc.get("do_overfit", False)
        self.overfit_num_clouds = lc.get("overfit_num_clouds", 100)
        self.debug_loader = lc.get("debug_loader", False)

        self.T_velo_to_cam = load_velo_to_cam_transform()
        self.frame_num = lc.get("frames_per_seq", 1) if sequence_learning else 1
        self.feature_mode = model_config.get("values_mode", "reflectance")
        self.world_frame = lc.get("do_pose", True)
        self.cloud_scope = lc.get("cloud_scope", 1)
        self.shuffle_points = lc.get("shuffle_points", True)
        self.accumulate_clouds = lc.get("accumulate_clouds", False)
        self.cap_distance = lc.get("cap_distance", -1)
        self.min_distance = lc.get("min_distance", -1)
        self.seq_same_cloud = lc.get("seq_same_cloud", False)
        self.max_points = max_points

        self.rng = np.random.default_rng(seed)
        self.transformer = DataTransformer(lc.get("transformer", {}), split,
                                           self.rng)
        self._pose_cache: dict = {}

        if self.nr_clouds_to_read == -1:
            self.dataset_size = int(np.sum(self.dataset_lengths)) - self.nr_clouds_to_skip
        else:
            self.dataset_size = self.nr_clouds_to_read
        if self.do_overfit:
            self.dataset_size = self.overfit_num_clouds
        elif self.debug_loader:
            self.dataset_size = 1

    def __len__(self):
        return self.dataset_size

    # -- pose helpers -----------------------------------------------------

    def _poses(self, seq: int) -> list:
        if seq not in self._pose_cache:
            base = os.path.join(self.data_dir, "sequences", f"{seq:02d}")
            calib = parse_calibration(os.path.join(base, "calib.txt"))
            self._pose_cache[seq] = parse_poses(
                os.path.join(base, "poses.txt"), calib)
        return self._pose_cache[seq]

    # -- item assembly ----------------------------------------------------

    def _locate(self, index: int):
        """Map a flat index to (sequence id, scan indices of the window)."""
        offsets = (np.arange(self.frame_num) - (self.frame_num - 1)) * self.cloud_scope
        if self.seq_same_cloud:
            offsets = np.zeros(self.frame_num, dtype=np.int64)
        cum = np.cumsum(self.dataset_lengths)
        last = 0
        for i, c in enumerate(cum):
            if index < c:
                seq = int(self.split_seqs[self.split][i])
                real_idx = index - last
                return seq, np.maximum(offsets + real_idx, 0)
            last = c
        raise IndexError(index)

    def _native_frames(self, seq, scan_ids, is_training):
        """Parallel C++ per-frame load (native/kitti_loader.cpp); returns
        the same (clouds, labels, refl, paths) as the NumPy path or None."""
        from . import native_loader
        if native_loader.get_lib() is None or self.debug_loader:
            return None
        paths = [os.path.join(self.data_dir, "sequences", f"{seq:02d}",
                              "velodyne", f"{sid:06d}.bin") for sid in scan_ids]
        label_paths = None
        if self.split not in ("test",):
            label_paths = [os.path.join(self.data_dir, "sequences",
                                        f"{seq:02d}", "labels",
                                        f"{sid:06d}.label") for sid in scan_ids]
        if self.world_frame:
            poses = self._poses(seq)
            pose_list = [poses[sid] for sid in scan_ids]
            inv_first = np.linalg.inv(poses[scan_ids[0]])
        else:
            pose_list, inv_first = None, None
        cap = self.cap_distance if is_training else -1
        mind = self.min_distance if is_training else -1
        out = native_loader.load_frames(
            paths, label_paths, self.remap_lut, pose_list, inv_first,
            cap, mind, self.max_points)
        if out is None:
            return None
        xyz, refl, labels, counts = out
        clouds = [np.ascontiguousarray(xyz[i, :counts[i]]) for i in range(len(paths))]
        labels_seq = [labels[i, :counts[i]].copy() for i in range(len(paths))]
        refl_seq = [refl[i, :counts[i]].copy() for i in range(len(paths))]
        return clouds, labels_seq, refl_seq, paths

    def __getitem__(self, index: int) -> list[FrameBatch]:
        if self.debug_loader:
            index = 4541 + 1101 + 4661 + 801 + 200
        index += self.nr_clouds_to_skip
        is_training = self.split == "train"

        seq, scan_ids = self._locate(index)

        native = self._native_frames(seq, scan_ids, is_training) \
            if self.use_native else None
        if native is not None:
            clouds, labels_seq, refl_seq, paths = native
            if self.shuffle_points and is_training:
                for i in range(len(clouds)):
                    perm = self.rng.permutation(clouds[i].shape[0])
                    clouds[i] = clouds[i][perm]
                    labels_seq[i] = labels_seq[i][perm]
                    refl_seq[i] = refl_seq[i][perm]
            return self._finalize(clouds, labels_seq, refl_seq, paths)

        poses = self._poses(seq) if self.world_frame else None
        first_pose = poses[scan_ids[0]] if self.world_frame else None
        rot_x = rotation_matrix(-90, "x")

        clouds, labels_seq, refl_seq, paths = [], [], [], []
        for i, sid in enumerate(scan_ids):
            path = os.path.join(self.data_dir, "sequences", f"{seq:02d}",
                                "velodyne", f"{sid:06d}.bin")
            scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
            xyz, refl = scan[:, :3], scan[:, 3]

            if self.split == "test":
                label = np.zeros(xyz.shape[0], np.int32)
            elif self.debug_loader:
                label = np.full(xyz.shape[0], i, np.int32)
            else:
                lpath = os.path.join(self.data_dir, "sequences", f"{seq:02d}",
                                     "labels", f"{sid:06d}.label")
                label = load_label(lpath, self.remap_lut)

            if self.cap_distance >= 0 and is_training:
                keep = np.linalg.norm(xyz, axis=1) < self.cap_distance
                xyz, label, refl = xyz[keep], label[keep], refl[keep]
            if self.min_distance >= 0 and is_training:
                keep = np.linalg.norm(xyz, axis=1) > self.min_distance
                xyz, label, refl = xyz[keep], label[keep], refl[keep]

            hom = np.concatenate([xyz, np.ones((xyz.shape[0], 1))], 1).T
            if self.world_frame:
                world = poses[sid] @ hom
                aligned = np.linalg.inv(first_pose) @ world
                ros = rot_x @ aligned
                xyz = (ros[:3] / ros[3]).T
            else:
                xyz = (rot_x @ hom)[:3].T

            if self.shuffle_points and is_training:
                perm = self.rng.permutation(xyz.shape[0])
                xyz, label, refl = xyz[perm], label[perm], refl[perm]

            clouds.append(np.ascontiguousarray(xyz, np.float32))
            labels_seq.append(label)
            refl_seq.append(refl.astype(np.float32))
            paths.append(path)

        return self._finalize(clouds, labels_seq, refl_seq, paths)

    def _finalize(self, clouds, labels_seq, refl_seq, paths) -> list[FrameBatch]:
        """Shared tail: augmentation, feature assembly, accumulate, padding."""
        extras = [[l, r] for l, r in zip(labels_seq, refl_seq)]
        clouds, extras = self.transformer.transform(clouds, extras)
        labels_seq = [e[0] for e in extras]
        refl_seq = [e[1] for e in extras]

        frames = []
        for xyz, label, refl, path in zip(clouds, labels_seq, refl_seq, paths):
            if self.feature_mode == "reflectance":
                vals = refl.reshape(-1, 1)
            else:
                vals = np.ones((xyz.shape[0], 1), np.float32)
            frames.append((np.asarray(xyz, np.float32),
                           np.asarray(vals, np.float32),
                           np.asarray(label, np.int32), path))

        if self.accumulate_clouds:
            xyz = np.concatenate([f[0] for f in frames])
            vals = np.concatenate([f[1] for f in frames])
            lab = np.concatenate([f[2] for f in frames])
            last_n = frames[-1][0].shape[0]
            if xyz.shape[0] > self.max_points:
                # Drop the OLDEST points: the last scan is what gets scored
                # and written (test_ln.py:221), so it must survive intact.
                if not getattr(self, "_warned_accum_overflow", False):
                    print(f"[kitti] accumulate: {xyz.shape[0]} points exceed "
                          f"max_points={self.max_points}; dropping oldest -- "
                          f"raise runtime.max_points for accumulate configs")
                    self._warned_accum_overflow = True
                xyz, vals, lab = (xyz[-self.max_points:], vals[-self.max_points:],
                                  lab[-self.max_points:])
            return [pad_frame(xyz, vals, lab, self.max_points, frames[-1][3],
                              last_n=last_n)]

        return [pad_frame(x, v, l, self.max_points, p)
                for (x, v, l, p) in frames]

    def __iter__(self):
        order = np.arange(len(self))
        yield from (self[int(i)] for i in order)
