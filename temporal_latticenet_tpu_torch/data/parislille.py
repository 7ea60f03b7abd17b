"""Paris-Lille-3D dataset: GPS-time-windowed pseudo-scan sequences (a copy
of the JAX package's ``data/parislille.py``).

Re-creates ``ParisLille3DDataset``
(upstream dataloader/parisLille_dataloader.py:23-258): each large
mobile-mapping ``.ply`` is cut into 2-second GPS-time windows stepped every
second; a "sequence" is a window plus its ``cloud_scope``-strided
predecessors.  Points are centred on the cloud's first origin, rotated -90
degrees about x (z-forward), labels remapped fine->coarse (10 or 12
classes).  Window index tables are cached to ``.npy`` exactly like the
reference (:87-157).

The reference declares this dataset unsupported in its CLI
(train_ln.py:69); it is fully supported here.
"""

from __future__ import annotations

import os

import numpy as np

from . import parislille_meta as meta
from .kitti import FrameBatch, pad_frame
from .ply import read_ply_vertices
from .transforms import DataTransformer, rotation_matrix

SAMPLE_INTERVAL = 2.0   # seconds of measurements per pseudo-scan
TIME_STEP = 1.0         # window stride in seconds


class ParisLille3DDataset:
    def __init__(self, split: str, loader_config: dict, model_config: dict,
                 sequence_learning: bool, max_points: int = 131072,
                 seed: int | None = None):
        lc = loader_config
        self.split = split
        self.data_dir = lc["dataset_path"]
        self.validation_cloud = lc.get("validation_cloud", "")
        self.include_moving = lc.get("include_moving_classes", False) and split != "test"
        self.frame_num = lc.get("frames_per_seq", 1) if sequence_learning else 1
        self.feature_mode = model_config.get("values_mode", "reflectance")
        self.cloud_scope = lc.get("cloud_scope", 1)
        self.shuffle_points = lc.get("shuffle_points", False)
        self.accumulate_clouds = lc.get("accumulate_clouds", False)
        self.cap_distance = lc.get("cap_distance", -1)  # min points per window here (sic, :145-147)
        self.seq_same_cloud = lc.get("seq_same_cloud", False)
        self.subsample_percentage = lc.get("subsample_percentage", 0.0)
        self.max_points = max_points
        self.rng = np.random.default_rng(seed)
        self.transformer = DataTransformer(lc.get("transformer", {}), split,
                                           self.rng)

        ply_files = sorted(
            os.path.join(self.data_dir, f) for f in os.listdir(self.data_dir)
            if f.endswith(".ply"))

        self.xyz_list, self.refl_list, self.class_list = [], [], []
        self.start_end_list, self.dataset_lengths, self.dataset_names = [], [], []

        cache = os.path.join(
            self.data_dir,
            "npys_{}{}".format(split, "_moving" if self.include_moving else ""))
        if os.path.exists(cache):
            def L(n):
                return np.load(os.path.join(cache, n + ".npy"), allow_pickle=True)
            self.xyz_list = list(L("xyz_list"))
            self.refl_list = list(L("reflectance_list"))
            self.class_list = list(L("class_list"))
            self.start_end_list = list(L("start_end_list"))
            self.dataset_lengths = list(L("dataset_lengths"))
            self.dataset_names = list(L("dataset_names"))
        else:
            for ply_file in ply_files:
                if split == "train" and ply_file.endswith(self.validation_cloud):
                    continue
                if split == "valid" and not ply_file.endswith(self.validation_cloud):
                    continue
                self._ingest(ply_file)
            os.makedirs(cache, exist_ok=True)
            for n, v in [("xyz_list", self.xyz_list),
                         ("reflectance_list", self.refl_list),
                         ("class_list", self.class_list),
                         ("start_end_list", self.start_end_list),
                         ("dataset_lengths", self.dataset_lengths),
                         ("dataset_names", self.dataset_names)]:
                np.save(os.path.join(cache, n),
                        np.asarray(v, dtype=object), allow_pickle=True)

        self.dataset_lengths = [int(x) for x in self.dataset_lengths]
        self.dataset_size = int(np.sum(self.dataset_lengths))
        if lc.get("nr_clouds_to_read", -1) != -1:
            self.dataset_size = lc["nr_clouds_to_read"]
        if lc.get("do_overfit", False):
            self.dataset_size = lc.get("overfit_num_clouds", 100)
        elif lc.get("debug_loader", False):
            self.dataset_size = 1

    def _ingest(self, ply_file: str):
        v = read_ply_vertices(ply_file)
        origin0 = np.array([v["x_origin"][0], v["y_origin"][0],
                            v["z_origin"][0]], np.float32) \
            if "x_origin" in v.dtype.names else np.zeros(3, np.float32)
        xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32) - origin0
        self.xyz_list.append(xyz)
        self.dataset_names.append(ply_file)

        if "reflectance" in v.dtype.names:
            self.refl_list.append(v["reflectance"].astype(np.float32))
        else:
            self.refl_list.append(np.ones(len(v), np.float32))

        if "class" in v.dtype.names and self.split != "test":
            cls = meta.fine_to_coarse(np.asarray(v["class"]), self.include_moving)
        else:
            cls = np.zeros(len(v), np.int32)
        self.class_list.append(cls)

        gps = np.asarray(v["GPS_time"], np.float64)
        starts = np.arange(gps[0] + SAMPLE_INTERVAL, gps[-1] - SAMPLE_INTERVAL,
                           TIME_STEP)
        s = np.searchsorted(gps, starts - SAMPLE_INTERVAL)
        e = np.searchsorted(gps, starts + SAMPLE_INTERVAL)
        if len(e):
            e[-1] = len(gps)
        se = np.unique(np.stack([s, e], 1), axis=0)
        if self.cap_distance > 0:
            se = se[(se[:, 1] - se[:, 0]) > self.cap_distance]
        self.start_end_list.append(se)
        self.dataset_lengths.append(se.shape[0])

    def __len__(self):
        return self.dataset_size

    def _single(self, dataset_idx: int, index: int):
        s, e = self.start_end_list[dataset_idx][index]
        sel = slice(int(s), int(e))
        xyz = self.xyz_list[dataset_idx][sel].astype(np.float32).copy()
        rot = rotation_matrix(-90, "x")[:3, :3]
        xyz = xyz @ rot.T

        label = (self.class_list[dataset_idx][sel].astype(np.int32).copy()
                 if self.split != "test" else np.zeros(xyz.shape[0], np.int32))
        if self.feature_mode == "reflectance":
            refl = self.refl_list[dataset_idx][sel, None].astype(np.float32)
        else:
            refl = np.ones((xyz.shape[0], 1), np.float32)

        if self.shuffle_points:
            perm = self.rng.permutation(xyz.shape[0])
            xyz, label, refl = xyz[perm], label[perm], refl[perm]

        if self.subsample_percentage > 0 and xyz.shape[0] > 100000:
            keep = self.rng.random(xyz.shape[0]) >= self.subsample_percentage
            xyz, label, refl = xyz[keep], label[keep], refl[keep]

        return xyz, refl, label, str(self.dataset_names[dataset_idx])

    def __getitem__(self, index: int) -> list[FrameBatch]:
        real_idx, dataset_idx = index, 0
        for di, n in enumerate(self.dataset_lengths):
            if real_idx < n:
                dataset_idx = di
                break
            real_idx -= n

        offsets = (np.arange(self.frame_num) - (self.frame_num - 1)) * self.cloud_scope
        if self.seq_same_cloud:
            offsets = np.zeros(self.frame_num, np.int64)
        ids = np.maximum(offsets + real_idx, 0)

        clouds, extras, paths = [], [], []
        for i in ids:
            xyz, refl, label, path = self._single(dataset_idx, int(i))
            clouds.append(xyz)
            extras.append([label, refl])
            paths.append(path)
        clouds, extras = self.transformer.transform(clouds, extras)

        frames = [(c, e[1].reshape(-1, 1), e[0], p)
                  for c, e, p in zip(clouds, extras, paths)]
        if self.accumulate_clouds:
            xyz = np.concatenate([f[0] for f in frames])
            vals = np.concatenate([f[1] for f in frames])
            lab = np.concatenate([f[2] for f in frames])
            last_n = frames[-1][0].shape[0]
            if xyz.shape[0] > self.max_points:
                # keep the newest points; the last scan is scored/written
                if not getattr(self, "_warned_accum_overflow", False):
                    print(f"[parislille] accumulate: {xyz.shape[0]} points "
                          f"exceed max_points={self.max_points}; dropping "
                          f"oldest -- raise runtime.max_points for "
                          f"accumulate configs")
                    self._warned_accum_overflow = True
                xyz, vals, lab = (xyz[-self.max_points:], vals[-self.max_points:],
                                  lab[-self.max_points:])
            return [pad_frame(xyz, vals, lab, self.max_points, frames[-1][3],
                              last_n=last_n)]
        return [pad_frame(x, v, l, self.max_points, p)
                for (x, v, l, p) in frames]

    def __iter__(self):
        yield from (self[i] for i in range(len(self)))
