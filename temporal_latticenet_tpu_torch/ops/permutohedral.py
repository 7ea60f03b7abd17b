"""Permutohedral lattice math: elevation, enclosing simplex, barycentric
weights (port of the JAX package's ``ops/permutohedral.py``).

Points in R^d are embedded into the hyperplane {x in R^(d+1): sum(x) = 0},
tiled by the simplices of the A_d* lattice (Adams, Baek & Davis, EG 2010).
Every operation keeps the JAX package's order of floating-point operations,
so keys and barycentric weights are bit-equal to it for the same scaled
input ``y`` (see :func:`scale_positions`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["scale_factors", "scale_positions", "elevate",
           "find_enclosing_simplex", "neighbor_offsets"]


@functools.lru_cache(maxsize=None)
def scale_factors(d: int) -> np.ndarray:
    """``s[j] = (d+1) sqrt(2/3) / sqrt((j+1)(j+2))``, as float32."""
    inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
    j = np.arange(d, dtype=np.float64)
    return (inv_std_dev / np.sqrt((j + 1) * (j + 2))).astype(np.float32)


def scale_positions(positions: torch.Tensor, sigma: float) -> torch.Tensor:
    """``y = (positions / sigma) * scale_factors`` in float32.

    The divisor is a device tensor, not a Python scalar: CUDA turns a
    division by a host scalar into a multiplication by its reciprocal,
    which is not bit-equal to the division the CPU performs."""
    d = positions.shape[-1]
    dev = positions.device
    s = torch.from_numpy(scale_factors(d)).to(dev)
    div = torch.tensor(sigma, dtype=torch.float32, device=dev)
    return (positions.to(torch.float32) / div) * s


def elevate_scaled(y: torch.Tensor) -> torch.Tensor:
    """(N, d) scaled positions -> (N, d+1) hyperplane coordinates:
    ``elevated[i] = sum_{j>=i} y_j - i * y_{i-1}``, suffix sums in the
    reversed-cumsum order."""
    d = y.shape[-1]
    suffix = [None] * d
    suffix[d - 1] = y[..., d - 1]
    for i in range(d - 2, -1, -1):
        suffix[i] = suffix[i + 1] + y[..., i]
    cols = [suffix[0]]
    for i in range(1, d + 1):
        tail = suffix[i] if i < d else torch.zeros_like(y[..., 0])
        cols.append(tail - float(i) * y[..., i - 1])
    return torch.stack(cols, dim=-1)


def elevate(positions: torch.Tensor, sigma: float) -> torch.Tensor:
    """Embed (N, d) positions into the (N, d+1) hyperplane."""
    return elevate_scaled(scale_positions(positions, sigma))


def _rank_differential(diff: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j : diff[j] > diff[i]} + #{j < i : diff[j] == diff[i]}."""
    n = diff.shape[-1]
    a = diff[..., :, None]
    b = diff[..., None, :]
    idx = torch.arange(n, device=diff.device)
    j_lt_i = idx[None, :] < idx[:, None]
    cmp = (b > a) | ((b == a) & j_lt_i)
    return cmp.sum(dim=-1).to(torch.int32)


def find_enclosing_simplex(elevated: torch.Tensor):
    """(N, d+1) elevated points -> (keys (N, d+1, d) int32, bary (N, d+1)
    float32); vertex r of the simplex is its remainder-r corner."""
    dp1 = elevated.shape[-1]
    d = dp1 - 1
    f_dp1 = float(dp1)

    v = elevated / f_dp1                      # power of two: exact
    up = torch.ceil(v) * f_dp1
    down = torch.floor(v) * f_dp1
    rem0 = torch.where(up - elevated < elevated - down, up, down)
    rem0 = rem0.to(torch.int32)

    sum_s = rem0.sum(dim=-1, dtype=torch.int32)
    if dp1 & (dp1 - 1) == 0:
        sum_g = sum_s >> (int(dp1).bit_length() - 1)
    else:
        sum_g = torch.div(sum_s, dp1, rounding_mode="floor")

    diff = elevated - rem0.to(torch.float32)
    rank = _rank_differential(diff) + sum_g[..., None]
    too_low = (rank < 0).to(torch.int32) * dp1
    too_high = (rank > d).to(torch.int32) * dp1
    rem0 = rem0 + too_low - too_high
    rank = rank + too_low - too_high

    delta = (elevated - rem0.to(torch.float32)) / f_dp1
    k = torch.arange(dp1 + 1, dtype=torch.int32, device=elevated.device)
    lo = ((d - rank)[..., :, None] == k).to(delta.dtype)
    hi = ((dp1 - rank)[..., :, None] == k).to(delta.dtype)
    # at most two nonzero terms per column: the sum is exact in any order
    bary_ext = (delta[..., :, None] * (lo - hi)).sum(dim=-2)
    bary = bary_ext[..., :dp1].clone()
    bary[..., 0] = bary[..., 0] + (1.0 + bary_ext[..., dp1])

    r = torch.arange(dp1, dtype=torch.int32, device=elevated.device)[:, None]
    rem0_d = rem0[..., None, :d]
    rank_d = rank[..., None, :d]
    keys = rem0_d + r - (rank_d > d - r).to(torch.int32) * dp1
    return keys.to(torch.int32), bary.to(torch.float32)


@functools.lru_cache(maxsize=None)
def neighbor_offsets(d: int) -> np.ndarray:
    """(2(d+1), d) int32 one-hop offsets, ordered [+o_0..+o_d, -o_0..-o_d]."""
    offs = []
    for a in range(d + 1):
        full = np.ones(d + 1, dtype=np.int32)
        full[a] = -d
        offs.append(full[:d])
    offs = np.stack(offs, axis=0)
    return np.concatenate([offs, -offs], axis=0)
