"""Temporal fusion modules (port of the JAX package's ``models/fusion.py``:
GRU, LSTM, CGA, MaxPool, Linear and AFlow).

Uniform call: ``out, new_h = module(lv, h, prev_count, count, is_first,
nbr)``.  The hidden value array ``h`` is carried at static capacity;
``prev_count`` (the level's vertex count when ``h`` was written) replaces
the reference's dynamic zero-padding.  On the first frame every module is
the identity.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import lattice_ops as lo
from .blocks import Conv1x1, Gn, Linear, uniform_


def _pad_hidden(h, prev_count, value: float):
    """Rows at or above ``prev_count`` read ``value`` (the reference's pad)."""
    rows = torch.arange(h.shape[0], device=h.device)
    return torch.where((rows < prev_count)[:, None], h,
                       torch.full((), value, dtype=h.dtype, device=h.device))


class _GRUCell(nn.Module):
    """torch.nn.GRUCell equations, gate order [r, z, n], two bias vectors;
    parameters in torch.nn.GRUCell's layout and names."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden))

    def init_weights(self, gen):
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            uniform_(p, bound, gen)

    def forward(self, x, h):
        gi = lo.matmul_f32(x, self.weight_ih.t()) + self.bias_ih
        gh = lo.matmul_f32(h, self.weight_hh.t()) + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class GRUFusion(nn.Module):
    """h <- Linear(h), zero-padded, then a per-vertex GRU cell."""

    def __init__(self, input_size: int, channels: int):
        super().__init__()
        self.hidden_linear = Linear(channels, channels)
        self.GRU = _GRUCell(input_size, channels)

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            hh = _pad_hidden(self.hidden_linear(h), prev_count, 0.0)
            out = self.GRU(lv, hh)
        out = lo.mask_rows(out, count)
        return out, out


class _LSTMCell(nn.Module):
    """torch.nn.LSTMCell equations, gate order [i, f, g, o], two bias
    vectors; parameters in torch.nn.LSTMCell's layout and names."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))

    def init_weights(self, gen):
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            uniform_(p, bound, gen)

    def forward(self, x, h, c):
        g = (lo.matmul_f32(x, self.weight_ih.t()) + self.bias_ih
             + lo.matmul_f32(h, self.weight_hh.t()) + self.bias_hh)
        i, f, gg, o = g.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class LSTMFusion(nn.Module):
    """h <- Linear(h), zero-padded, then a per-vertex LSTM cell whose cell
    state is always zero and whose new cell state is discarded (reference
    quirk)."""

    def __init__(self, input_size: int, channels: int):
        super().__init__()
        self.hidden_linear = Linear(channels, channels)
        self.lstm = _LSTMCell(input_size, channels)

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            hh = _pad_hidden(self.hidden_linear(h), prev_count, 0.0)
            out, _ = self.lstm(lv, hh, torch.zeros_like(hh))
        out = lo.mask_rows(out, count)
        return out, out


class CGAFusion(nn.Module):
    """Cross-frame global attention: the hidden state gates the current
    features.  Reference quirks kept: the same 1x1 conv (no bias) is applied
    twice, the "global average pool" is the scalar 1/(count + channels), and
    the gates of vertices new since the previous frame are one."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.hidden_linear = Linear(channels, channels)
        self.conv = Conv1x1(channels, channels, bias=False)
        self.groupnorm = Gn(channels)

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            hh = _pad_hidden(self.hidden_linear(h), prev_count, 0.0)
            g = torch.relu(self.conv(hh, count))
            g = self.conv(self.groupnorm(g, count), count)
            n = torch.as_tensor(count, device=g.device).to(torch.float32)
            g = torch.sigmoid(g * (1.0 / (n + self.channels)))
            rows = torch.arange(lv.shape[0], device=lv.device)
            g = torch.where((rows >= prev_count)[:, None],
                            torch.ones((), device=g.device), g)
            out = g * lv
        out = lo.mask_rows(out, count)
        return out, out


class MaxPoolFusion(nn.Module):
    """Elementwise max with the hidden state; vertices new since the
    previous frame read the -9999 pad.  No parameters."""

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            out = torch.maximum(_pad_hidden(h, prev_count, -9999.0), lv)
        out = lo.mask_rows(out, count)
        return out, out


class LinearFusion(nn.Module):
    """lv <- ReLU(Linear(cat[Linear(h) zero-padded, lv]))."""

    def __init__(self, input_size: int, channels: int):
        super().__init__()
        self.hidden_linear = Linear(channels, channels)
        self.linear = Linear(channels + input_size, channels)

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            hh = _pad_hidden(self.hidden_linear(h), prev_count, 0.0)
            out = torch.relu(self.linear(torch.cat([hh, lv], dim=-1)))
        out = lo.mask_rows(out, count)
        return out, out


class _AFlowParams(nn.Module):
    """alpha, beta, the (unused in the forward) conv weight, and the bias,
    under the reference's ``AFLOW`` name."""

    def __init__(self, channels: int, k: int, train_alpha_beta: bool,
                 use_bias: bool):
        super().__init__()
        self.k = k
        if train_alpha_beta:
            self.alpha = nn.Parameter(torch.full((), 0.1))
            self.beta = nn.Parameter(torch.full((), 0.1))
        else:
            self.register_buffer("alpha", torch.full((), 0.1),
                                 persistent=False)
            self.register_buffer("beta", torch.full((), 0.1),
                                 persistent=False)
        self.weight = nn.Parameter(torch.zeros(k * channels, channels))
        self.bias = nn.Parameter(torch.empty(channels)) if use_bias else None

    def init_weights(self, gen):
        with torch.no_grad():
            self.alpha.fill_(0.1)
            self.beta.fill_(0.1)
            self.weight.zero_()
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(self.weight.shape[0]), gen)


class AFlowFusion(nn.Module):
    """Abstract Flow: per vertex, the 9 one-hop neighbors of the previous
    hidden state are weighted by w = (alpha - min(d, alpha)) * beta with
    row-normalised feature distances d; their weighted sum is concatenated
    with the current features through a Linear + ReLU.  New vertices read
    the -999999 pad, so their weights collapse to zero."""

    def __init__(self, channels: int, train_alpha_beta: bool = True,
                 use_center: bool = True, use_bias: bool = True, k: int = 9):
        super().__init__()
        self.use_center = use_center
        self.AFLOW = _AFlowParams(channels, k, train_alpha_beta, use_bias)
        self.linear = Linear(2 * channels, channels)

    def forward(self, lv, h, prev_count, count, is_first, nbr=None):
        if is_first:
            out = lv
        else:
            h_pad = _pad_hidden(h, prev_count, -999999.0)
            # the 8 neighbor taps through the gather whose backward is
            # another gather (the convolutions' im2row does the same)
            nbr_g = lo.gather8_sym(h_pad, nbr.idx[:, :8])
            h_nbr = torch.cat([nbr_g, h_pad[:, None, :]], dim=1)  # (cap, 9, C)
            found = nbr.found.to(torch.float32)
            dist = torch.sqrt(torch.clamp(
                ((h_nbr - lv[:, None, :]) ** 2).sum(dim=-1), min=1e-24))
            dist = dist * found
            if not self.use_center:
                dist = torch.cat([dist[:, :-1], torch.zeros_like(dist[:, -1:])],
                                 dim=1)
            # the normaliser gets no gradient, as in the JAX package
            denom = dist.sum(dim=1, keepdim=True).detach()
            dist = dist / torch.where(denom == 0.0, torch.ones_like(denom),
                                      denom)
            alpha, beta = self.AFLOW.alpha, self.AFLOW.beta
            w = (alpha - torch.minimum(dist, alpha)) * beta
            w = w * found
            if not self.use_center:
                w = torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], dim=1)
            aflow = torch.einsum("vkc,vk->vc", h_nbr * found[..., None], w)
            if self.AFLOW.bias is not None:
                aflow = aflow + self.AFLOW.bias
            out = torch.relu(self.linear(torch.cat([aflow, lv], dim=-1)))
        out = lo.mask_rows(out, count)
        return out, out


def make_fusion(kind: str, channels: int, cfg=None, input_size: int = None):
    """A fusion module by its cfg name; None for "none".  ``input_size`` is
    the width of the fused features when it differs from ``channels``."""
    if kind == "none":
        return None
    inp = channels if input_size is None else input_size
    if kind == "gru":
        return GRUFusion(inp, channels)
    if kind == "lstm":
        return LSTMFusion(inp, channels)
    if kind == "linear":
        return LinearFusion(inp, channels)
    if kind == "cga":
        return CGAFusion(channels)
    if kind == "maxpool":
        return MaxPoolFusion()
    if kind == "aflow":
        return AFlowFusion(
            channels,
            train_alpha_beta=(cfg.train_alpha_beta if cfg else True),
            use_center=(cfg.use_center if cfg else True))
    raise ValueError(f"unknown fusion {kind!r}")
