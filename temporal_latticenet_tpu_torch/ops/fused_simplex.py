"""Kernel K1: fused elevate + enclosing simplex + key pack.

Replaces the Pallas kernel ``ops/pallas_simplex.py:_simplex_kernel`` of the
JAX package (wrapper ``fused_simplex_pack``).  The CUDA kernel is
``csrc/fused_simplex.cu``: one thread per point, reading the pre-scaled
coordinates and writing the (N, 4) packed keys and barycentric weights
directly.  :func:`fused_simplex_pack_plain` is the same function in plain
PyTorch with the same order of float32 operations; both are bit-exact
against ``permutohedral.elevate_scaled`` + ``find_enclosing_simplex`` +
``vertex_table.pack_keys``.

The packed key of simplex vertex r follows from the rounded remainder-0
point and the coordinate ranks without materialising the (N, 4, 3) keys:

    m_j(r) = (rem0_j >> 2) - [rank_j > 3 - r] + 512
    packed(r) = m_0 << 22 | m_1 << 12 | m_2 << 2 | r   (0xFFFFFFFF if masked
                                                         or m_j not in [0, 1021])
"""

from __future__ import annotations

import torch

from . import _cuda
from .vertex_table import PACKED_SENTINEL

_BIAS = 512
_MMAX = 1021


def fused_simplex_pack_plain(y: torch.Tensor, mask: torch.Tensor):
    """(N, 3) float32 pre-scaled points + (N,) bool mask ->
    (packed (N, 4) int64, bary (N, 4) float32)."""
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    t2 = y2
    t1 = y2 + y1
    t0 = t1 + y0
    e = [t0, t1 - 1.0 * y0, t2 - 2.0 * y1, 0.0 - 3.0 * y2]

    remf, remi = [], []
    for i in range(4):
        v = e[i] / 4.0
        up = torch.ceil(v) * 4.0
        down = torch.floor(v) * 4.0
        rf = torch.where(up - e[i] < e[i] - down, up, down)
        remf.append(rf)
        remi.append(rf.to(torch.int32))
    sum_g = ((remi[0] + remi[1]) + (remi[2] + remi[3])) >> 2

    diff = [e[i] - remf[i] for i in range(4)]
    rank = []
    for i in range(4):
        r = None
        for j in range(4):
            if j == i:
                continue
            c = (diff[j] > diff[i]) if j > i else (diff[j] >= diff[i])
            ci = c.to(torch.int32)
            r = ci if r is None else r + ci
        rank.append(r + sum_g)
    for i in range(4):
        adj = (rank[i] < 0).to(torch.int32) * 4 - (rank[i] > 3).to(torch.int32) * 4
        remi[i] = remi[i] + adj
        rank[i] = rank[i] + adj

    delta = [(e[i] - remi[i].to(torch.float32)) / 4.0 for i in range(4)]

    def bary_ext(k):
        t = []
        for i in range(4):
            lo = (rank[i] == 3 - k).to(torch.float32)
            hi = (rank[i] == 4 - k).to(torch.float32)
            t.append(delta[i] * (lo - hi))
        return (t[0] + t[1]) + (t[2] + t[3])

    b = [bary_ext(k) for k in range(5)]
    b[0] = b[0] + (1.0 + b[4])
    bary = torch.stack(b[:4], dim=-1)

    mb = [(remi[j] >> 2).to(torch.int64) + _BIAS for j in range(3)]
    outs = []
    for r in range(4):
        a = [mb[j] - (rank[j] > 3 - r).to(torch.int64) for j in range(3)]
        ok = mask.clone()
        for j in range(3):
            ok &= (a[j] >= 0) & (a[j] <= _MMAX)
        packed = (a[0] << 22) | (a[1] << 12) | (a[2] << 2) | r
        outs.append(torch.where(ok, packed,
                                torch.full_like(packed, PACKED_SENTINEL)))
    return torch.stack(outs, dim=-1), bary


def fused_simplex_pack(y: torch.Tensor, mask: torch.Tensor):
    """Candidate keys and barycentric weights of every point.

    Args:
      y: (N, 3) float32 pre-scaled positions (``permutohedral.scale_positions``),
        contiguous.
      mask: (N,) bool point validity.
    Returns (packed (N, 4) int64, bary (N, 4) float32); row-major flatten
    gives the union's candidate order (point-major, vertex-minor).
    """
    if y.dim() != 2 or y.shape[1] != 3 or y.dtype != torch.float32:
        raise ValueError(f"y must be (N, 3) float32, got {tuple(y.shape)} "
                         f"{y.dtype}")
    if mask.shape != (y.shape[0],) or mask.dtype != torch.bool:
        raise ValueError("mask must be (N,) bool")
    if mask.device != y.device:
        raise ValueError("y and mask must be on one device")
    if y.device.type == "cpu":
        return fused_simplex_pack_plain(y, mask)
    if not y.is_cuda:
        raise ValueError(f"unsupported device {y.device}")
    if not (y.is_contiguous() and mask.is_contiguous()):
        raise ValueError("y and mask must be contiguous")
    n = y.shape[0]
    packed = torch.empty((n, 4), dtype=torch.int64, device=y.device)
    bary = torch.empty((n, 4), dtype=torch.float32, device=y.device)
    fn = _cuda.function("fused_simplex", "tln_fused_simplex",
                        [_cuda.P, _cuda.P, _cuda.I64, _cuda.P, _cuda.P,
                         _cuda.P])
    err = fn(y.data_ptr(), mask.data_ptr(), n, packed.data_ptr(),
             bary.data_ptr(), _cuda.stream_ptr())
    _cuda.check("fused_simplex", err, "fused_simplex_pack")
    _cuda.LAUNCHES["fused_simplex_pack"] += 1
    return packed, bary
