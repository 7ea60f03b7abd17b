"""ctypes bindings for the native C++ frame loader (native/kitti_loader.cpp
at the repository root, shared with the JAX package; a copy of its
``data/native_loader.py``).

Auto-builds the shared library on first use (g++ is part of the toolchain);
falls back to None when unavailable so the pure-NumPy path keeps working.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libtln_native.so"))

_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.tln_load_frames.restype = ctypes.c_int
    lib.tln_load_frames.argtypes = [
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_void_p,  # poses (double*) or None
        ctypes.c_void_p,  # inv_first_pose or None
        ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return _lib


def load_frames(scan_paths, label_paths, remap_lut, poses, inv_first_pose,
                cap_distance, min_distance, max_points):
    """Parallel native load of a sequence window.

    Args mirror the per-frame hot path of SemanticKittiDataset.__getitem__
    (kitti_dataloader.py:123-186).  ``label_paths`` may be None (test split),
    ``poses``/``inv_first_pose`` may be None (``do_pose: false``).

    Returns (xyz (F, P, 3) f32, refl (F, P) f32, labels (F, P) i32,
    counts (F,) i32) or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    f = len(scan_paths)
    scan_arr = (ctypes.c_char_p * f)(*[s.encode() for s in scan_paths])
    if label_paths is not None:
        label_arr = (ctypes.c_char_p * f)(*[s.encode() for s in label_paths])
    else:
        label_arr = None
    lut = np.ascontiguousarray(remap_lut, np.int32)
    xyz = np.zeros((f, max_points, 3), np.float32)
    refl = np.zeros((f, max_points), np.float32)
    labels = np.zeros((f, max_points), np.int32)
    counts = np.zeros((f,), np.int32)

    poses_c = None
    inv_c = None
    if poses is not None:
        poses_np = np.ascontiguousarray(np.stack(poses), np.float64)
        poses_c = poses_np.ctypes.data_as(ctypes.c_void_p)
        inv_np = np.ascontiguousarray(inv_first_pose, np.float64)
        inv_c = inv_np.ctypes.data_as(ctypes.c_void_p)

    status = lib.tln_load_frames(
        f, scan_arr, label_arr, lut, np.int32(lut.shape[0]),
        poses_c, inv_c,
        float(cap_distance), float(min_distance), np.int32(max_points),
        xyz, refl, labels, counts)
    if status != 0:
        raise IOError(f"native loader failed with status {status}")
    return xyz, refl, labels, counts
