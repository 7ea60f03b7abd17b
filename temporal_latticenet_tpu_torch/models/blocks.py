"""Per-vertex building blocks: masked GroupNorm, 1x1 convs, lattice convs,
the ResNet/Bottleneck blocks, GN-ReLU-{Conv, Coarsen, Finefy} and the deform
slice (port of the JAX package's ``models/blocks.py``).

Submodule and parameter names follow the reference PyTorch schema (the one
``train/torch_convert.export_state_dict`` of the JAX package writes), so
its state_dicts load with ``strict=True``: torch Linear layout (out, in) for
1x1 convs and linears, (9*in, out) for lattice convs, GroupNorm affine
parameters under ``gn.gn``.

Every array is capacity-padded (cap, C) with a device-tensor occupancy
``count``; rows outside [1, count) stay exactly zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import lattice_ops as lo
from ..ops.group_norm import masked_gn_relu, masked_group_norm, valid_rows


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


def torch_linear_init(weight, bias, fan_in: int, gen) -> None:
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    uniform_(weight, bound, gen)
    if bias is not None:
        uniform_(bias, bound, gen)


def lattice_conv_kernel_init(weight, fan_in: int, gen) -> None:
    """Kaiming-uniform over the true fan-in with ReLU gain."""
    uniform_(weight, math.sqrt(6.0 / fan_in), gen)


class Linear(nn.Module):
    """y = x @ weight.T + bias in float32, weight in torch layout (out, in).

    ``init``: "torch" (torch.nn.Linear's default), "zeros", or
    "kaiming_normal" (weight N(0, 2/fan_in), bias torch-uniform)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, init: str = "torch"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)
        self.init = init

    def init_weights(self, gen):
        fan_in = self.weight.shape[1]
        if self.init == "zeros":
            with torch.no_grad():
                self.weight.zero_()
                if self.bias is not None:
                    self.bias.zero_()
            return
        torch_linear_init(self.weight, self.bias, fan_in, gen)
        if self.init == "kaiming_normal":
            with torch.no_grad():
                self.weight.copy_(torch.randn(self.weight.shape, generator=gen)
                                  * math.sqrt(2.0 / fan_in))

    def forward(self, x, compute_dtype=torch.float32):
        y = lo.matmul_f32(x, self.weight.t(), compute_dtype)
        return y if self.bias is None else y + self.bias


class MaskedGroupNorm(nn.Module):
    """GroupNorm over the valid rows only (eps 1e-5): the vertex rows
    [1, count), or the rows of ``mask`` where one is given (the attention
    pool's point rows, whose validity is scattered)."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, count, mask=None):
        valid = valid_rows(x.shape[0], count, x.device) if mask is None \
            else mask
        return masked_group_norm(x, valid, self.weight, self.bias,
                                 self.epsilon)


class Gn(nn.Module):
    """The reference's GroupNorm wrapper: parameters live under ``gn.gn``."""

    def __init__(self, channels: int):
        super().__init__()
        self.gn = MaskedGroupNorm(channels)

    def forward(self, x, count, mask=None):
        return self.gn(x, count, mask)

    def relu(self, x, count, mask=None):
        """``relu(self(x, count, mask))``; without a mask one
        :func:`masked_gn_relu` (kernel K7 on the card)."""
        if mask is not None:
            return torch.relu(self.gn(x, count, mask))
        return masked_gn_relu(x, count, self.gn.weight, self.gn.bias,
                              self.gn.epsilon)


class Conv1x1(Linear):
    """Per-vertex linear map; masks the result to the valid rows (those of
    ``mask`` where one is given)."""

    def forward(self, x, count, mask=None):
        y = super().forward(x)
        if mask is not None:
            return torch.where(mask[:, None], y,
                               torch.zeros((), device=y.device))
        return lo.mask_rows(y, count)


class LatticeConv(nn.Module):
    """One-hop lattice convolution over a 9-tap NeighborTable; the weight is
    (9*in, out).  With ``dtype='bfloat16'`` the gather and the product
    operands are bf16 and the product accumulates in float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = False, dtype: str = "float32", k: int = 9):
        super().__init__()
        self.fan_in = k * in_channels
        self.weight = nn.Parameter(torch.empty(self.fan_in, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.compute_dtype = torch_dtype(dtype)

    def init_weights(self, gen):
        lattice_conv_kernel_init(self.weight, self.fan_in, gen)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(self.fan_in), gen)

    def forward(self, x, nbr, count):
        return lo.lattice_conv(x, nbr, self.weight, count, self.bias,
                               self.compute_dtype)


class GnRelu1x1(nn.Module):
    def __init__(self, in_channels, out_channels, use_bias=False):
        super().__init__()
        self.gn = Gn(in_channels)
        self.conv = Conv1x1(in_channels, out_channels, use_bias)

    def forward(self, x, count, mask=None):
        return self.conv(self.gn.relu(x, count, mask), count, mask)


class GnReluConv(nn.Module):
    def __init__(self, in_channels, out_channels, use_bias=False,
                 dtype="float32"):
        super().__init__()
        self.gn = Gn(in_channels)
        self.conv = LatticeConv(in_channels, out_channels, use_bias, dtype)

    def forward(self, x, nbr, count):
        return self.conv(self.gn.relu(x, count), nbr, count)


class ResnetBlock(nn.Module):
    """Two pre-activation GN-ReLU-Conv layers with identity shortcut."""

    def __init__(self, channels, biases=(False, False), dtype="float32"):
        super().__init__()
        self.conv1 = GnReluConv(channels, channels, biases[0], dtype)
        self.conv2 = GnReluConv(channels, channels, biases[1], dtype)

    def forward(self, x, nbr, count):
        y = self.conv2(self.conv1(x, nbr, count), nbr, count)
        return lo.mask_rows(y + x, count)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> lattice conv -> 1x1 expand, identity shortcut."""

    def __init__(self, channels, biases=(False, False, False),
                 dtype="float32"):
        super().__init__()
        mid = channels // 2
        self.contract = GnRelu1x1(channels, mid, biases[0])
        self.conv = GnReluConv(mid, mid, biases[1], dtype)
        self.expand = GnRelu1x1(mid, channels, biases[2])

    def forward(self, x, nbr, count):
        y = self.contract(x, count)
        y = self.conv(y, nbr, count)
        y = self.expand(y, count)
        return lo.mask_rows(y + x, count)


class GnReluCoarsen(nn.Module):
    """GN -> ReLU -> barycentric splat onto the coarse level -> lattice conv
    at the coarse level."""

    def __init__(self, in_channels, out_channels, dtype="float32"):
        super().__init__()
        self.gn = Gn(in_channels)
        self.conv = LatticeConv(in_channels, out_channels, False, dtype)

    def forward(self, fine_values, fine_count, link, coarse_nbr,
                coarse_count):
        x = self.gn.relu(fine_values, fine_count)
        pooled = lo.splat_to_coarse(x, link, coarse_nbr.idx.shape[0])
        pooled = lo.mask_rows(pooled, coarse_count)
        return self.conv(pooled, coarse_nbr, coarse_count)


class GnReluFinefy(nn.Module):
    """GN -> ReLU -> lattice conv at the coarse level -> barycentric slice
    back onto the fine vertices."""

    def __init__(self, in_channels, out_channels, dtype="float32"):
        super().__init__()
        self.gn = Gn(in_channels)
        self.conv = LatticeConv(in_channels, out_channels, False, dtype)

    def forward(self, coarse_values, coarse_count, coarse_nbr, link,
                fine_count):
        x = self.gn.relu(coarse_values, coarse_count)
        x = self.conv(x, coarse_nbr, coarse_count)
        return lo.mask_rows(lo.slice_to_fine(x, link), fine_count)


class DeformSlice(nn.Module):
    """Deform-slice + classifier: per point, gather the 4 simplex-vertex
    features, predict a delta to the barycentric weights (zero-initialised;
    no delta and no ``linear_deltaW`` without ``deform``, the
    ``slice_no_deform`` experiment), blend, drop out, classify linearly.

    Dropout (rate ``dropout``) runs only where the caller passes a ``keep``
    mask, drawn by :meth:`dropout_keep` from an explicit generator: the
    training step draws one for the final frame; every forward without
    gradients passes none."""

    def __init__(self, channels, nr_classes, deform=True, dropout=0.0,
                 dp1=4):
        super().__init__()
        self.channels = channels
        self.deform = deform
        self.dropout = dropout
        if deform:
            self.linear_deltaW = Linear(dp1 * channels + dp1, dp1,
                                        init="zeros")
        self.linear_clasify = Linear(channels, nr_classes)

    def dropout_keep(self, points: int, gen: torch.Generator):
        """A (points, channels) bool mask, True where a feature is kept
        (with probability 1 - ``dropout``), drawn from ``gen`` on its
        device."""
        return torch.rand((points, self.channels), generator=gen,
                          device=gen.device) < 1.0 - self.dropout

    def forward(self, values, point_vertex, point_bary, keep=None):
        p, dp1 = point_vertex.shape
        # out-of-range indices (only under a flagged trim overflow) clamp
        # like a JAX gather; the backward leaves out the rows that read the
        # invalid row 0 (``values`` is mask_rows-clean)
        g = lo.gather_rows(values, point_vertex.clamp(max=values.shape[0] - 1))
        bary = point_bary
        if self.deform:
            feats = g.reshape(p, -1)
            delta = self.linear_deltaW(torch.cat([feats, point_bary], dim=-1))
            delta = torch.where(point_bary != 0.0, delta,
                                torch.zeros((), device=delta.device))
            bary = point_bary + delta
        sliced = torch.einsum("pvc,pv->pc", g, bary)
        if keep is not None:
            sliced = torch.where(keep, sliced / (1.0 - self.dropout),
                                 torch.zeros((), device=sliced.device))
        return self.linear_clasify(sliced)
