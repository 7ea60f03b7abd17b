"""SemanticKITTI dataset metadata (a copy of the JAX package's).

Factual content of the public SemanticKITTI API configuration (label id
remapping, sequence splits, per-sequence scan counts), consumed by the
reference through ``seq_config/semantic-kitti{,-all}.yaml``
(upstream dataloader/kitti_dataloader.py:38-49).  Held here as plain
Python data so the loader needs no yaml side-files; a yaml with the same
schema can still be supplied and takes precedence (see kitti.py).
"""

from __future__ import annotations

import numpy as np

# raw label id -> training id, 20-class single-scan setting
# (moving classes folded into their static counterparts)
LEARNING_MAP_20 = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14,
    52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0,
    252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

# 26-class multi-scan setting: moving classes keep their own training ids
LEARNING_MAP_26 = dict(LEARNING_MAP_20)
LEARNING_MAP_26.update({
    252: 20, 253: 21, 254: 22, 255: 23, 256: 24, 257: 24, 258: 25, 259: 24,
})

LEARNING_MAP_INV_20 = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}

LEARNING_MAP_INV_26 = dict(LEARNING_MAP_INV_20)
LEARNING_MAP_INV_26.update({
    20: 252, 21: 253, 22: 254, 23: 255, 24: 259, 25: 258,
})

SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "valid": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
}

# official scan counts per sequence, used for sequence-window index
# arithmetic (kitti_dataloader.py:49,105-118)
SPLIT_LENGTHS = {
    "train": [4541, 1101, 4661, 801, 271, 2761, 1101, 1101, 1591, 1201],
    "valid": [4071],
    "test": [921, 1061, 3281, 631, 1901, 1731, 491, 1801, 4981, 831, 2721],
}


def build_remap_lut(include_moving_classes: bool) -> np.ndarray:
    """Raw-label -> training-label lookup table (+100 slack like the
    reference, kitti_dataloader.py:44-47)."""
    m = LEARNING_MAP_26 if include_moving_classes else LEARNING_MAP_20
    lut = np.zeros(max(m.keys()) + 100, dtype=np.int32)
    lut[list(m.keys())] = list(m.values())
    return lut


def build_inverse_lut(include_moving_classes: bool) -> np.ndarray:
    """Training-label -> raw-label table (the semantic-kitti-api
    ``remap_semantic_labels.py --inverse`` step, test_ln.py:234-248)."""
    m = LEARNING_MAP_INV_26 if include_moving_classes else LEARNING_MAP_INV_20
    lut = np.zeros(max(m.keys()) + 1, dtype=np.uint32)
    lut[list(m.keys())] = list(m.values())
    return lut


def nr_classes(include_moving_classes: bool) -> int:
    return 26 if include_moving_classes else 20
