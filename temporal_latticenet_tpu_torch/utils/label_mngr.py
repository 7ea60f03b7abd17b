"""LabelMngr: label names, colors, frequencies and the unlabeled index (a
copy of the JAX package's).

Headless re-creation of the easy_pbr ``LabelMngr`` the reference constructs
from the metadata text files (upstream train_ln.py:97-101;
``get_idx_unlabeled`` used at callbacks/state_callback.py:16,
``color_from_label_indices`` at test_ln.py:33-44).  Can be built either
from the reference-format files or directly from the bundled
``class_meta`` data.
"""

from __future__ import annotations

import numpy as np

from ..data import class_meta


def _read_data_lines(path: str) -> list[str]:
    with open(path) as f:
        return [l.strip() for l in f
                if l.strip() and not l.strip().startswith("#")]


class LabelMngr:
    def __init__(self, labels_file: str | None = None,
                 colorscheme_file: str | None = None,
                 frequency_file: str | None = None,
                 unlabeled_idx: int = 0, dataset: str = "semantickitti",
                 include_moving: bool = True):
        if labels_file:
            self.names = _read_data_lines(labels_file)
            self.colors_bgr = np.array(
                [[int(x) for x in l.split(",")] for l in
                 _read_data_lines(colorscheme_file)], np.int32)
            self.frequencies = np.array(
                [float(x) for x in _read_data_lines(frequency_file)])
        elif dataset == "semantickitti":
            self.names = list(class_meta.KITTI_LABEL_NAMES)
            self.colors_bgr = np.array(class_meta.KITTI_COLORS_BGR, np.int32)
            self.frequencies = np.array(
                class_meta.KITTI_FREQUENCIES_26 if include_moving
                else class_meta.KITTI_FREQUENCIES_20)
        else:
            self.names = list(class_meta.PL3D_LABEL_NAMES)
            self.colors_bgr = np.array(class_meta.PL3D_COLORS_BGR, np.int32)
            self.frequencies = np.array(class_meta.PL3D_FREQUENCIES)
        self.unlabeled_idx = unlabeled_idx

    def get_idx_unlabeled(self) -> int:
        return self.unlabeled_idx

    def nr_classes(self) -> int:
        return len(self.names)

    def label_name(self, idx: int) -> str:
        return self.names[idx]

    def color_rgb(self, idx: int) -> np.ndarray:
        return self.colors_bgr[idx][::-1] / 255.0

    def color_from_label_indices(self, labels: np.ndarray) -> np.ndarray:
        """(N,) labels -> (N, 3) float RGB in [0, 1]."""
        labels = np.asarray(labels).reshape(-1)
        bgr = self.colors_bgr[np.clip(labels, 0, len(self.names) - 1)]
        return bgr[:, ::-1].astype(np.float64) / 255.0


def compute_class_weights(class_frequencies: np.ndarray,
                          background_idx: int) -> np.ndarray:
    """Inverse-log frequency class weights
    (LNN_SEQ.compute_class_weights, models.py:535-548)."""
    w = 1.0 / np.log(1.05 + np.asarray(class_frequencies, np.float64))
    w[background_idx] = 1e-8
    return w.astype(np.float32)
