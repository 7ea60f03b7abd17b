"""PointNet splat head (port of the JAX package's ``PointNetSeq``: the
batched ``_reduce_sorted``, the per-frame path of ``__call__`` for
experiment "none" in bf16, and ``_fuse_and_conv``).

Offline, the per-row MLP runs for all frames at once over the union-sorted
rows; every (vertex, frame) bucket is a contiguous sub-run there, so the
per-vertex max is one segmented max scan (kernel K4, or K5 and K4 under
``TLN_MAXSCAN_PACKED=1``, through ``ops/segment.sorted_packed_max``) read
at the bucket tails; its gradient flows straight through to the winning
rows.  Streaming, one frame's rows go through the MLP and one packed
scatter max (``ops/segment.segment_max_with_bary_packed``).  Each frame
then goes on with its reduced tensor: early temporal fusion and the first
lattice convolution.  Reference quirks kept: the winning row's barycentric
weight is concatenated per channel, and vertices touched by fewer than 4
rows are zeroed (except under early maxpool fusion).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import lattice_ops as lo
from ..ops.segment import segment_max_with_bary_packed, sorted_packed_max
from .blocks import LatticeConv, Linear, torch_dtype
from .fusion import make_fusion


class PointNetSeq(nn.Module):
    def __init__(self, cfg: ModelConfig, n_values: int = 1):
        super().__init__()
        self.cfg = cfg
        widths = [3 + n_values] + list(cfg.pointnet_layers)
        self.layers = nn.ModuleList(
            Linear(widths[i], widths[i + 1], init="kaiming_normal")
            for i in range(len(cfg.pointnet_layers)))
        self.last_conv = LatticeConv(cfg.early_channels,
                                     cfg.pointnet_start_nr_channels,
                                     use_bias=False, dtype=cfg.compute_dtype)
        if cfg.sequence_learning and cfg.rnn_modules[0] != "none":
            self.fusion_module = make_fusion(
                cfg.rnn_modules[0], cfg.early_channels, cfg,
                input_size=2 * cfg.pointnet_layers[-1])
        else:
            self.fusion_module = None

    def _mlp(self, x, cd):
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x, cd).to(cd)
            if i < n - 1:
                x = torch.relu(x)
        return x

    def _zero_sparse(self, reduced, nr_points):
        """Vertices touched by fewer than 4 rows are zeroed, except under
        early maxpool fusion."""
        cfg = self.cfg
        if cfg.sequence_learning and cfg.rnn_modules[0] == "maxpool":
            return reduced
        return torch.where((nr_points >= 4)[..., None], reduced,
                           torch.zeros((), device=reduced.device))

    def reduce_frame(self, dist, values_rows, cap: int):
        """One frame's MLP + packed max (the streaming path).

        Args:
          dist: this frame's ``DistributeOut``; values_rows: (P*4, V)
            float32 point values per row, zero on invalid rows.
        Returns (cap, 2*C) float32: per-channel maxima, then the winning
        rows' barycentric weights.
        """
        cfg = self.cfg
        if cfg.experiment != "none" or cfg.compute_dtype != "bfloat16" \
                or cfg.reference_bary_quirk:
            raise NotImplementedError(
                "the per-frame pointnet is ported for experiment 'none' in "
                "bf16 only")
        rid, rvalid = dist.row_vertex, dist.row_valid
        x = self._mlp(torch.cat([dist.row_rel_pos, values_rows], dim=-1)
                      .to(torch.bfloat16), torch.bfloat16)
        nr_points = lo.segment_sum(rvalid.to(torch.float32), rid, cap)
        mx, bary_sel = segment_max_with_bary_packed(x, dist.row_bary, rid,
                                                    cap, rvalid)
        return self._zero_sparse(torch.cat([mx, bary_sel], dim=-1), nr_points)

    def reduce_sorted(self, spn, values, row_bary, nr_points_all):
        """All-frames MLP + packed max over union-sorted rows.

        Args:
          spn: ``SortedPN`` of the sequence lattice.
          values: (T, P, V) float32 point values.
          row_bary: (T, P*4) float32.
          nr_points_all: (T, cap) float32 valid rows per vertex and frame.
        Returns (T, cap, 2*C) float32: per-channel maxima, then the winning
        rows' barycentric weights.
        """
        cd = torch_dtype(self.cfg.compute_dtype)
        t, p, v = values.shape
        live = spn.live
        if spn.vals is not None:
            vals_s = (spn.vals * live[:, None]).to(torch.float32)
            bary_s = torch.where(live, spn.bary, torch.zeros_like(spn.bary))
        else:
            vals_flat = values.reshape(t * p, v).repeat_interleave(4, dim=0)
            vb = torch.cat([vals_flat, row_bary.reshape(-1, 1)], dim=1)[spn.so]
            vals_s = vb[:, :v] * live[:, None]
            bary_s = vb[:, v]
        x = self._mlp(torch.cat([spn.rel, vals_s], dim=-1).to(cd), cd)
        mx, bary_sel = sorted_packed_max(x, bary_s, live, spn.head_count,
                                         spn.bucket, spn.tailpos,
                                         nr_points_all > 0)
        cap = nr_points_all.shape[1]
        c = x.shape[-1]
        reduced = torch.cat([mx.reshape(t, cap, c),
                             bary_sel.reshape(t, cap, c)], dim=-1)
        return self._zero_sparse(reduced, nr_points_all)

    def fuse_and_conv(self, reduced, nbr, count, h_early, prev_count,
                      is_first):
        """Early temporal fusion + the first lattice conv of one frame."""
        new_h = h_early
        if self.fusion_module is not None:
            reduced, new_h = self.fusion_module(reduced, h_early, prev_count,
                                                count, is_first, nbr)
        reduced = lo.mask_rows(reduced, count)
        return self.last_conv(reduced, nbr, count), new_h
