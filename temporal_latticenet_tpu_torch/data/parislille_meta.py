"""Paris-Lille-3D dataset metadata (a copy of the JAX package's).

Factual content of the public Paris-Lille-3D class hierarchy (npm3d.fr):
fine 9-digit class ids -> 10 coarse classes (stationary setting) or 12
classes (with Moving-person=10 / Moving-car=11), plus the 12->10 inverse
map used at submission time.  Consumed by the reference through the XML /
yaml side-files (upstream dataloader/parisLille_dataloader.py:62-77).
"""

from __future__ import annotations

import numpy as np

# fine id -> coarse id, stationary (10-class) setting
FINE_TO_COARSE_10 = {
    0: 0, 100000000: 0, 200000000: 0, 201000000: 0,
    202000000: 1, 202010000: 1, 202020000: 1, 202030000: 1, 202040000: 1,
    202050000: 1, 202060000: 1,
    203000000: 2,
    300000000: 0, 301000000: 0, 302000000: 0, 302010000: 0, 302020000: 0,
    302020100: 0, 302020200: 3, 302020300: 4, 302020400: 3, 302020500: 3,
    302020600: 3, 302020700: 0, 302020800: 0, 302020900: 5, 302021000: 0,
    302021100: 0, 302021200: 0, 302021300: 0,
    302030000: 0, 302030100: 0, 302030200: 6, 302030300: 6, 302030400: 6,
    302030500: 0, 302030600: 0, 302030700: 6,
    302040000: 0, 302040100: 0, 302040200: 0, 302040300: 0, 302040400: 0,
    302040500: 0, 302040600: 0, 302040700: 2, 302040800: 0,
    303000000: 0, 303010000: 0,
    303020000: 7, 303020100: 7, 303020200: 7, 303020300: 7, 303020400: 7,
    303020500: 7, 303020600: 7, 303020700: 0, 303020800: 7, 303020900: 7,
    303021000: 0,
    303030000: 0, 303030100: 0, 303030200: 0, 303030201: 0, 303030202: 0,
    303030203: 0, 303030204: 0, 303030300: 0, 303030301: 0, 303030302: 0,
    303030303: 0, 303030304: 0, 303030400: 0, 303030401: 0, 303030402: 0,
    303030403: 0, 303030404: 0, 303030500: 0, 303030501: 0, 303030502: 0,
    303030503: 0, 303030504: 0,
    303040000: 0, 303040100: 0,
    303040200: 8, 303040201: 8, 303040202: 8, 303040203: 8, 303040204: 8,
    303040300: 8, 303040301: 8, 303040302: 8, 303040303: 8, 303040304: 8,
    303040400: 0, 303040401: 0, 303040402: 0, 303040403: 0, 303040404: 0,
    303040500: 0, 303040501: 0, 303040502: 0, 303040503: 0, 303040504: 0,
    303050000: 0, 303050100: 0, 303050200: 0, 303050300: 0, 303050400: 0,
    303050500: 0, 303050600: 0,
    304000000: 9, 304010000: 9, 304020000: 9, 304030000: 9,
    304040000: 0, 304050000: 0,
}

# 12-class (moving) setting differs only in the moving pedestrian/car leaves
FINE_TO_COARSE_12 = dict(FINE_TO_COARSE_10)
FINE_TO_COARSE_12.update({
    303020300: 10, 303020400: 10, 303020500: 10, 303020800: 10, 303020900: 10,
    303040202: 11, 303040203: 11, 303040302: 11, 303040303: 11,
})

# training (12) -> submission (10): moving classes fold back
TWELVE_TO_TEN = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8, 9: 9,
                 10: 7, 11: 8}


def fine_to_coarse(labels: np.ndarray, include_moving: bool) -> np.ndarray:
    """Vectorised fine->coarse remap (the reference loops over the pairs,
    parisLille_dataloader.py:182-186; here a sorted lookup)."""
    m = FINE_TO_COARSE_12 if include_moving else FINE_TO_COARSE_10
    keys = np.array(sorted(m.keys()), dtype=np.int64)
    vals = np.array([m[k] for k in keys], dtype=np.int32)
    idx = np.searchsorted(keys, labels.astype(np.int64))
    idx = np.clip(idx, 0, len(keys) - 1)
    out = vals[idx]
    out[keys[idx] != labels.astype(np.int64)] = 0  # unknown ids -> unclassified
    return out


def twelve_to_ten_lut() -> np.ndarray:
    lut = np.zeros(max(TWELVE_TO_TEN) + 100, dtype=np.int32)
    lut[list(TWELVE_TO_TEN.keys())] = list(TWELVE_TO_TEN.values())
    return lut


def nr_classes(include_moving: bool) -> int:
    return 12 if include_moving else 10
