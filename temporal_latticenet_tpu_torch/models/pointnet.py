"""PointNet splat head (port of the JAX package's ``PointNetSeq``: the
batched ``_reduce_sorted``, the per-frame path of ``__call__`` for
experiment "none" in bf16 and float32, and ``_fuse_and_conv``).

Offline, the per-row MLP runs for all frames at once over the union-sorted
rows; every (vertex, frame) bucket is a contiguous sub-run there, so the
per-vertex max is one segmented max scan (kernel K4, or K5 and K4 under
``TLN_MAXSCAN_PACKED=1``, through ``ops/segment.sorted_packed_max``) read
at the bucket tails; its gradient flows straight through to the winning
rows.  Per frame (streaming, and the offline route without the batched
pointnet), one frame's rows go through the MLP and one packed scatter max
(``ops/segment.segment_max_with_bary_packed``) in bf16, or the float32
``segment_max_with_argmax``.  Each frame then goes on with its reduced
tensor: early temporal fusion and the first lattice convolution.  Reference
quirks kept: the winning row's barycentric weight is concatenated per
channel, vertices touched by fewer than 4 rows are zeroed (except under
early maxpool fusion, where the rows a frame does not touch read -9900
before the fusion), and ``reference_bary_quirk``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import lattice_ops as lo
from ..ops.segment import (segment_max_with_argmax,
                           segment_max_with_bary_packed, sorted_packed_max)
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

    def reduce_frame(self, dist, values_rows, cap: int, count=None,
                     nr_points=None, drop_past_cap: bool = False):
        """One frame's MLP + max: the streaming path, and the offline
        non-batched route.  In bf16, one packed scatter max carries the
        maxima and the winning rows' barycentric weights; in float32,
        ``segment_max_with_argmax`` and a gather of the winning row's weight,
        which under ``reference_bary_quirk`` reads row 0's weight for every
        winning row index outside [0, count] (the reference's indexing).

        Args:
          dist: this frame's ``DistributeOut``; values_rows: (P*4, V)
            float32 point values per row, zero on invalid rows.
          count: the frame's level-0 vertex count (read by the quirk).
          nr_points: (cap,) float32 valid rows per vertex, when the caller
            has them (the sequence lattice's); else summed here.
          drop_past_cap: leave out the rows whose vertex lies at or past
            ``cap``: a trimmed view of the sequence lattice has them under a
            flagged trim overflow; the streaming tables never do.
        Returns (cap, 2*C) float32: per-channel maxima, then the winning
        rows' barycentric weights.
        """
        cfg = self.cfg
        if cfg.experiment != "none":
            raise NotImplementedError(
                f"the pointnet experiment {cfg.experiment!r} is not ported to "
                f"PyTorch yet")
        cd = torch_dtype(cfg.compute_dtype)
        if cd == torch.bfloat16 and cfg.reference_bary_quirk:
            raise ValueError("reference_bary_quirk needs the float32 argmax "
                             "path (compute_dtype='float32')")
        rid, rvalid = dist.row_vertex, dist.row_valid
        if drop_past_cap:
            inside = rid < cap
            rid, rvalid = torch.where(inside, rid, 0), rvalid & inside
        x = self._mlp(torch.cat([dist.row_rel_pos, values_rows], dim=-1)
                      .to(cd), cd)
        if nr_points is None:
            nr_points = lo.segment_sum(rvalid.to(torch.float32), rid, cap)
        if cd == torch.bfloat16:
            mx, bary_sel = segment_max_with_bary_packed(x, dist.row_bary, rid,
                                                        cap, rvalid)
        else:
            mx, arg = segment_max_with_argmax(x, rid, cap, rvalid)
            mx = mx.to(torch.float32)
            if cfg.reference_bary_quirk:
                bary_sel = dist.row_bary[torch.where(
                    (arg >= 0) & (arg <= count), arg, 0)]
            else:
                bary_sel = torch.where(arg >= 0,
                                       dist.row_bary[arg.clamp(min=0)],
                                       torch.zeros((), device=arg.device))
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
            if self.cfg.rnn_modules[0] == "maxpool":
                # rows this frame does not touch read -9900, so that the
                # previous frame wins the max
                half = reduced.shape[-1] // 2
                rowsum = reduced[:, :half].abs().sum(dim=-1, keepdim=True)
                reduced = torch.where(rowsum == 0.0, torch.full(
                    (), -9900.0, device=reduced.device), reduced)
            reduced, new_h = self.fusion_module(reduced, h_early, prev_count,
                                                count, is_first, nbr)
        reduced = lo.mask_rows(reduced, count)
        return self.last_conv(reduced, nbr, count), new_h
