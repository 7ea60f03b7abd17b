"""PointNet splat head (port of the JAX package's ``PointNetSeq``: the
batched ``_reduce_sorted``, the per-frame path of ``__call__`` with every
``experiment`` ablation, in bf16 and float32, and ``_fuse_and_conv``).

Offline, the per-row MLP runs for all frames at once over the union-sorted
rows; every (vertex, frame) bucket is a contiguous sub-run there, so the
per-vertex max is one segmented max scan (kernel K4, or K5 and K4 under
``TLN_MAXSCAN_PACKED=1``, through ``ops/segment.sorted_packed_max``) read
at the bucket tails; its gradient flows straight through to the winning
rows.  Per frame (streaming, the offline route without the batched
pointnet, and every experiment), one frame's rows go through the MLP and
one packed scatter max (``ops/segment.segment_max_with_bary_packed``) in
bf16, or the float32 ``segment_max_with_argmax``.  Each frame then goes on
with its reduced tensor: early temporal fusion and the first lattice
convolution.  Reference quirks kept: the winning row's barycentric weight
is concatenated per channel, vertices touched by fewer than 4 rows are
zeroed (except under early maxpool fusion, where the rows a frame does not
touch read -9900 before the fusion), and ``reference_bary_quirk``.

The experiments (the reference's ablations; C = ``pointnet_layers[-1]``,
V the point values' width):

* ``slice_no_deform``, ``pointnet_no_local_mean``: the pointnet as
  ``none`` (the latter's rows hold raw positions, from the lattice build);
* ``pointnet_no_elevate`` and ``..._no_local_mean``: no MLP; the float32
  rows (rel, values) go through the argmax max, width 2(3+V);
* ``splat``: no MLP; the rows' mean per vertex, width 3+V, no barycentric
  weights, zeroed only where no row lands;
* ``attention_pool``: the MLP over (rel, values, bary), then each row plus
  ``gamma`` times its vertex's max, a bias-free 1x1 ``pre_conv`` and two
  GN-ReLU-1x1s (``att_activ``, ``att_scores``) whose GroupNorm statistics
  run over the valid rows; the exponentiated scores, normalised per
  vertex, weight a sum of the rows: width C.

:func:`reduced_width` gives the width; an early fusion other than "none"
needs 2C and raises for the experiments that change it, as the JAX
package cannot run them either.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import lattice_ops as lo
from ..ops.segment import (segment_max_with_argmax,
                           segment_max_with_bary_packed, segment_mean,
                           sorted_packed_max)
from ..utils.profiling import span
from .blocks import GnRelu1x1, LatticeConv, Linear, torch_dtype
from .fusion import make_fusion

NO_ELEVATE = ("pointnet_no_elevate", "pointnet_no_elevate_no_local_mean",
              "splat")
NO_LOCAL_MEAN = ("pointnet_no_local_mean",
                 "pointnet_no_elevate_no_local_mean")


def subtract_local_mean(cfg: ModelConfig) -> bool:
    """Whether the rows' positions are taken relative to their vertex's
    mean (all but the no-local-mean experiments)."""
    return cfg.experiment not in NO_LOCAL_MEAN


def reduced_width(cfg: ModelConfig, n_values: int = 1) -> int:
    """The width of the pointnet's per-vertex reduction, which the early
    fusion and ``last_conv`` read."""
    c = cfg.pointnet_layers[-1]
    if cfg.experiment == "splat":
        return 3 + n_values
    if cfg.experiment in NO_ELEVATE:
        return 2 * (3 + n_values)
    if cfg.experiment == "attention_pool":
        return c
    return 2 * c


class PointNetSeq(nn.Module):
    def __init__(self, cfg: ModelConfig, n_values: int = 1):
        super().__init__()
        self.cfg = cfg
        exp = cfg.experiment
        width = reduced_width(cfg, n_values)
        early = cfg.sequence_learning and cfg.rnn_modules[0] != "none"
        if early and width != cfg.early_channels:
            raise ValueError(
                f"experiment {exp!r} reduces to {width} channels, but the "
                f"early {cfg.rnn_modules[0]!r} fusion takes "
                f"{cfg.early_channels}: use the early fusion 'none'")
        widths = [3 + n_values + (exp == "attention_pool")] \
            + list(cfg.pointnet_layers)
        self.layers = nn.ModuleList(
            Linear(widths[i], widths[i + 1], init="kaiming_normal")
            for i in range(0 if exp in NO_ELEVATE
                           else len(cfg.pointnet_layers)))
        if exp == "attention_pool":
            c = cfg.pointnet_layers[-1]
            self.gamma = nn.Parameter(torch.ones(c))
            self.pre_conv = Linear(c, c, bias=False, init="kaiming_normal")
            self.att_activ = GnRelu1x1(c, c, use_bias=False)
            self.att_scores = GnRelu1x1(c, c, use_bias=True)
        self.last_conv = LatticeConv(width, cfg.pointnet_start_nr_channels,
                                     use_bias=False, dtype=cfg.compute_dtype)
        if early:
            self.fusion_module = make_fusion(
                cfg.rnn_modules[0], cfg.early_channels, cfg,
                input_size=width)
        else:
            self.fusion_module = None

    def init_weights(self, gen):
        """``gamma`` starts at 1 (the submodules initialise themselves)."""
        if hasattr(self, "gamma"):
            with torch.no_grad():
                self.gamma.fill_(1.0)

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
        """One frame's MLP + reduction: the streaming path, the offline
        non-batched route, and every experiment.  Without an experiment, in
        bf16, one packed scatter max carries the maxima and the winning
        rows' barycentric weights; in float32 (and on the float32 rows of
        the no-elevate experiments), ``segment_max_with_argmax`` and a
        gather of the winning row's weight, which under
        ``reference_bary_quirk`` reads row 0's weight for every winning row
        index outside [0, count] (the reference's indexing).  ``splat`` and
        ``attention_pool`` reduce as the module docstring says.

        Args:
          dist: this frame's ``DistributeOut``; values_rows: (P*4, V)
            float32 point values per row, zero on invalid rows.
          count: the frame's level-0 vertex count (read by the quirk).
          nr_points: (cap,) float32 valid rows per vertex, when the caller
            has them (the sequence lattice's); else summed here.
          drop_past_cap: leave out the rows whose vertex lies at or past
            ``cap``: a trimmed view of the sequence lattice has them under a
            flagged trim overflow; the streaming tables never do.
        Returns (cap, :func:`reduced_width`) float32.
        """
        cfg = self.cfg
        exp = cfg.experiment
        cd = torch_dtype(cfg.compute_dtype)
        rid, rvalid = dist.row_vertex, dist.row_valid
        if drop_past_cap:
            inside = rid < cap
            rid, rvalid = torch.where(inside, rid, 0), rvalid & inside
        x = torch.cat([dist.row_rel_pos, values_rows], dim=-1)
        if exp == "attention_pool":
            x = torch.cat([x, dist.row_bary[:, None]], dim=-1)
        if len(self.layers):
            # the rows in compute_dtype; the no-elevate rows stay float32
            x = self._mlp(x.to(cd), cd)
        if nr_points is None:
            nr_points = lo.segment_sum(rvalid.to(torch.float32), rid, cap)
        zero = torch.zeros((), device=x.device)
        if exp == "splat":
            return torch.where((nr_points > 0)[:, None],
                               segment_mean(x, rid, cap, rvalid), zero)
        if exp == "attention_pool":
            return torch.where((nr_points >= 4)[:, None],
                               self._attention_pool(x, rid, rvalid, cap),
                               zero)
        if x.dtype == torch.bfloat16:
            if cfg.reference_bary_quirk:
                raise ValueError("reference_bary_quirk needs the float32 "
                                 "argmax path (compute_dtype='float32')")
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
                                       dist.row_bary[arg.clamp(min=0)], zero)
        return self._zero_sparse(torch.cat([mx, bary_sel], dim=-1), nr_points)

    def _attention_pool(self, x, rid, rvalid, cap: int):
        """Attention-weighted sum of each vertex's rows (``attention_pool``).
        The GN-ReLU-1x1s run over the point rows, their GroupNorm
        statistics over the valid rows only; the scores are exponentiated,
        zeroed on invalid rows and divided by their vertex's sum.  Row sums
        go through :func:`lattice_ops.segment_sum` (valid rows never lie in
        the invalid bucket 0).  The per-vertex values go back to the rows
        through :func:`lattice_ops.gather_rows`, whose backward spreads the
        invalid rows' reads of row 0 (autograd's would add them one after
        another: C-1's fault)."""
        mx, _ = segment_max_with_argmax(x, rid, cap, rvalid)
        xm = x + self.gamma * lo.gather_rows(mx, rid)
        pre = self.pre_conv(xm)
        act = self.att_activ(pre, pre.shape[0], rvalid)
        sc = self.att_scores(act, act.shape[0], rvalid)
        sc = torch.exp(sc) * rvalid[:, None]
        ssum = lo.segment_sum(sc, rid, cap)
        sc = sc / torch.clamp(lo.gather_rows(ssum, rid), min=1e-12)
        return lo.segment_sum(x * sc, rid, cap)

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
            with span("tln.model.fusion.early"):
                reduced, new_h = self.fusion_module(reduced, h_early,
                                                    prev_count, count,
                                                    is_first, nbr)
        reduced = lo.mask_rows(reduced, count)
        return self.last_conv(reduced, nbr, count), new_h
