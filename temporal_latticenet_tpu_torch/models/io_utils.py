"""Model input assembly and introspection (port of the JAX package's
``models/io_utils.py``).

* :func:`prepare_cloud`: (positions, values, target) arrays of a cloud
  record by ``positions_mode`` / ``values_mode``, as the reference's
  ``LNN_SEQ.prepare_cloud`` assembles them;
* :func:`summary`: parameter counts per submodule of a model, from its
  ``named_parameters``, and their total.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


class Cloud:
    """A cloud record: vertices ``V`` (N, 3), colours ``C`` (N, 3),
    intensity ``I`` (N,) or (N, 1) and labels ``L_gt`` (N,), the fields of
    the mesh record the reference's loaders fill."""

    def __init__(self, V=None, C=None, I=None, L_gt=None):
        self.V, self.C, self.I, self.L_gt = V, C, I, L_gt


def prepare_cloud(cloud: Cloud, positions_mode: str = "xyz",
                  values_mode: str = "reflectance"):
    """Returns (positions (N, P) float32, values (N, V) float32, target (N,)
    int32 or None)."""
    V = np.asarray(cloud.V, np.float32)
    if positions_mode == "xyz":
        positions = V
    elif positions_mode == "xyz+rgb":
        positions = np.concatenate([V, np.asarray(cloud.C, np.float32)], 1)
    elif positions_mode == "xyz+intensity":
        positions = np.concatenate([V, np.asarray(cloud.I, np.float32)
                                    .reshape(V.shape[0], -1)], 1)
    else:
        raise ValueError(f"positions mode {positions_mode!r} not implemented")

    if values_mode == "none":
        values = np.zeros((V.shape[0], 1), np.float32)
    elif values_mode in ("intensity", "reflectance"):
        values = np.asarray(cloud.I, np.float32).reshape(V.shape[0], -1)
    elif values_mode == "rgb":
        values = np.asarray(cloud.C, np.float32)
    elif values_mode == "rgb+height":
        values = np.concatenate([np.asarray(cloud.C, np.float32), V[:, 1:2]],
                                1)
    elif values_mode == "rgb+xyz":
        values = np.concatenate([np.asarray(cloud.C, np.float32), V], 1)
    elif values_mode == "height":
        values = V[:, 1:2]
    elif values_mode == "xyz":
        values = V
    else:
        raise ValueError(f"values mode {values_mode!r} not implemented")

    target = (np.asarray(cloud.L_gt).reshape(-1).astype(np.int32)
              if cloud.L_gt is not None else None)
    return positions, values, target


def summary(model: torch.nn.Module, file=sys.stderr) -> int:
    """Print the parameter count of every submodule (indented by depth, in
    name order) and the total; returns the total."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.numel()

    def count(node) -> int:
        return sum(count(v) if isinstance(v, dict) else v
                   for v in node.values())

    def walk(node, indent: int):
        for k in sorted(node):
            if isinstance(node[k], dict):
                print(f"{'  ' * indent}{k}: {count(node[k]):,} params",
                      file=file)
                walk(node[k], indent + 1)

    walk(tree, 0)
    total = count(tree)
    print(f"TOTAL: {total:,} params", file=file)
    return total
