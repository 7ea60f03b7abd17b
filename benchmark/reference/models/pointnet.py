"""Frozen copy of the port's ``models/pointnet.py`` (plain PyTorch only: no CUDA
kernel, no import of the port), cut to the route the benchmark compares
with.  Part of the benchmark's float32 reference; see
``benchmark/reference/__init__.py``.

PointNet splat head (the JAX package's ``PointNetSeq``).  Per frame, the
frame's rows (positions relative to their vertex's mean, and values) go
through the MLP and a scatter max per vertex (``segment_max_with_argmax``),
with the winning row's barycentric weight concatenated per channel;
vertices touched by fewer than 4 rows are zeroed.  Each frame then goes on
with its reduced tensor: early temporal fusion and the first lattice
convolution.  The port reduces all frames at once with kernel K4 (its
batched route); the maxima are the same.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import lattice_ops as lo
from ..ops.segment import segment_max_with_argmax
from .blocks import LatticeConv, Linear, torch_dtype
from .fusion import make_fusion


class PointNetSeq(nn.Module):
    def __init__(self, cfg: ModelConfig, n_values: int = 1):
        super().__init__()
        self.cfg = cfg
        width = 2 * cfg.pointnet_layers[-1]
        early = cfg.sequence_learning and cfg.rnn_modules[0] != "none"
        widths = [3 + n_values] + list(cfg.pointnet_layers)
        self.layers = nn.ModuleList(
            Linear(widths[i], widths[i + 1], init="kaiming_normal")
            for i in range(len(cfg.pointnet_layers)))
        self.last_conv = LatticeConv(width, cfg.pointnet_start_nr_channels,
                                     use_bias=False, dtype=cfg.compute_dtype)
        if early:
            self.fusion_module = make_fusion(
                cfg.rnn_modules[0], cfg.early_channels, cfg,
                input_size=width)
        else:
            self.fusion_module = None

    def _mlp(self, x, cd):
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lo.round_to(lin(x, cd), cd)
            if i < n - 1:
                x = torch.relu(x)
        return x

    def reduce_frame(self, dist, values_rows, cap: int, nr_points):
        """One frame's MLP + reduction.

        Args:
          dist: this frame's ``DistributeOut``; values_rows: (P*4, V)
            float32 point values per row, zero on invalid rows.
          nr_points: (cap,) float32 valid rows per vertex (the sequence
            lattice's).
        Returns (cap, 2 * C) float32: the per-channel maxima, then the
        winning rows' barycentric weights.
        """
        cd = torch_dtype(self.cfg.compute_dtype)
        rid, rvalid = dist.row_vertex, dist.row_valid
        # leave out the rows whose vertex lies at or past the capacity
        inside = rid < cap
        rid, rvalid = torch.where(inside, rid, 0), rvalid & inside
        x = torch.cat([dist.row_rel_pos, values_rows], dim=-1)
        x = self._mlp(lo.round_to(x, cd), cd)
        zero = torch.zeros((), device=x.device)
        mx, arg = segment_max_with_argmax(x, rid, cap, rvalid)
        mx = mx.to(torch.float32)
        bary_sel = torch.where(arg >= 0, dist.row_bary[arg.clamp(min=0)], zero)
        return torch.where((nr_points >= 4)[..., None],
                           torch.cat([mx, bary_sel], dim=-1), zero)

    def fuse_and_conv(self, reduced, nbr, count, h_early, prev_count,
                      is_first):
        """Early temporal fusion + the first lattice conv of one frame."""
        new_h = h_early
        if self.fusion_module is not None:
            reduced, new_h = self.fusion_module(reduced, h_early, prev_count,
                                                count, is_first, nbr)
        reduced = lo.mask_rows(reduced, count)
        return self.last_conv(reduced, nbr, count), new_h
