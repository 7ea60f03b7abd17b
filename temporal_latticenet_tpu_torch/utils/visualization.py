"""Headless visualisation exports (the PyTorch counterpart of the JAX
package's ``utils/visualization.py``).

* ``export_prediction_cloud`` -- colored prediction / ground-truth /
  difference clouds as PLY (the reference's viewer_callback.py:15-42 and
  RecordPLYs.py:44-141);
* ``export_aflow_arrays`` -- the AFlow attention data that
  ``visualize_cli`` writes per frame (weights, previous-frame neighbor
  indices and per-vertex mean positions, the reference's
  models.py:442-458,480-481), as ``.npz`` for offline plotting.  The data
  comes from ``LNNSeq.sow_aux``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.ply import write_ply_vertices
from .label_mngr import LabelMngr


def export_prediction_cloud(path: str, positions: np.ndarray,
                            pred: np.ndarray, label_mngr: LabelMngr,
                            gt: np.ndarray | None = None):
    """Write a point cloud PLY colored by predicted labels; when ``gt`` is
    given, also write ``*_gt.ply`` and ``*_diff.ply`` (red = wrong)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pos = np.asarray(positions, np.float32)

    def write(p, colors_rgb01, labels):
        c = (np.clip(colors_rgb01, 0, 1) * 255).astype(np.uint8)
        write_ply_vertices(p, {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "red": c[:, 0], "green": c[:, 1], "blue": c[:, 2],
            "label": np.asarray(labels, np.uint32),
        })

    base, ext = os.path.splitext(path)
    write(path, label_mngr.color_from_label_indices(pred), pred)
    if gt is not None:
        write(base + "_gt" + ext, label_mngr.color_from_label_indices(gt), gt)
        wrong = (np.asarray(pred) != np.asarray(gt))
        diff = np.where(wrong[:, None], np.array([[1.0, 0.0, 0.0]]),
                        np.array([[0.7, 0.7, 0.7]]))
        write(base + "_diff" + ext, diff, wrong.astype(np.uint32))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def vertex_mean_positions(positions, point_vertex, capacity: int
                          ) -> np.ndarray:
    """Per-vertex mean of contributing point positions (the scatter_mean of
    the reference's models.py:452-454), to place lattice vertices in 3D for
    plots.  ``point_vertex``: (P, 4) vertex rows of each point."""
    point_vertex = _host(point_vertex)
    pv = point_vertex.reshape(-1)
    pos = np.repeat(_host(positions), point_vertex.shape[1], axis=0)
    sums = np.zeros((capacity, 3))
    np.add.at(sums, pv, pos)
    cnt = np.zeros(capacity)
    np.add.at(cnt, pv, 1.0)
    return sums / np.maximum(cnt, 1.0)[:, None]


def export_aflow_arrays(path: str, aux_collection: dict, positions,
                        point_vertex, capacity: int):
    """Dump AFlow weights/neighbors + vertex positions to ``.npz``; returns
    the sorted array names.

    ``aux_collection`` is what ``LNNSeq.sow_aux`` yields (the JAX package's
    ``aux`` collection): {module path: {"aflow_weights": (w (V, 9), ...),
    "aflow_neighbors": (idx (V, 9), ...)}}; the first entry of each tuple
    is written, under "<module path>/<name>".
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = _host(v[0] if isinstance(v, (tuple, list))
                                         else v)

    walk(aux_collection)
    flat["avg_position_per_vertex"] = vertex_mean_positions(
        positions, point_vertex, capacity)
    np.savez_compressed(path, **flat)
    return sorted(flat.keys())
