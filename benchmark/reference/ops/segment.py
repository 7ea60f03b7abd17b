"""Frozen copy of the port's float32 ``segment_max_with_argmax`` from
``ops/segment.py`` (plain PyTorch only: no CUDA kernel, no import of the
port): the pointnet's per-vertex max.  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.
"""

from __future__ import annotations

import torch


def segment_max_with_argmax(data, segment_ids, num_segments: int,
                            valid=None):
    """Per-segment, per-channel max and the winning row (the JAX package's
    ``segment_max_with_argmax``, torch_scatter's ``scatter_max``
    semantics): empty segments give 0 and -1, invalid rows never win, and
    among tied rows the largest row index wins.  Both reductions are one
    ``scatter_reduce("amax")`` each (max is exact in any order); the
    gradient of the max is shared among tied rows, as the JAX package's
    scatter max shares it.

    Args:
      data: (R, C) rows; segment_ids: (R,) int64 in [0, num_segments);
      valid: optional (R,) bool.
    Returns (max (S, C) in data's dtype, argmax (S, C) int64).
    """
    r, c = data.shape
    neg = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
    masked = data if valid is None else torch.where(valid[:, None], data, neg)
    idx = segment_ids[:, None].expand(r, c)
    mx = torch.full((num_segments, c), float("-inf"), dtype=data.dtype,
                    device=data.device).scatter_reduce(0, idx, masked, "amax")
    has = torch.isfinite(mx)
    mxz = torch.where(has, mx, torch.zeros((), dtype=data.dtype,
                                           device=data.device))
    winner = masked == mx.detach()[segment_ids]
    if valid is not None:
        winner &= valid[:, None]
    rows = torch.arange(r, device=data.device)[:, None]
    none = torch.full((), -1, dtype=torch.int64, device=data.device)
    arg = torch.full((num_segments, c), -1, dtype=torch.int64,
                     device=data.device).scatter_reduce(
        0, idx, torch.where(winner, rows, none), "amax")
    return mxz, torch.where(has, arg, none)
