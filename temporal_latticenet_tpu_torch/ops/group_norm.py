"""The masked GroupNorm over a capacity-padded (cap, C) array, and its ReLU
as kernel K7 (``csrc/masked_gn.cu``).

:func:`masked_group_norm` is the plain version: GroupNorm over the rows of
``valid`` alone (eps 1e-5 in the model), zero on every other row.
:func:`masked_gn_relu` is ``relu(masked_group_norm(...))`` over the vertex
rows [1, count): on the card one :class:`_MaskedGnRelu`, whose forward is
three launches of K7 and whose backward two; on the CPU the plain version
under autograd, unchanged.  K7 keeps the plain version's formula (the mean
and the centred variance as two float32 sums over the valid elements, then
``(x - mean) * rsqrt(var + eps) * w + b``), so its results differ from it
only by the order of the sums, and each call gives the same bits."""

from __future__ import annotations

import functools

import torch

from ..utils.profiling import span
from . import _cuda


def gn_num_groups(channels: int) -> int:
    """32 groups, or channels/2 when channels <= 32; else the largest
    divisor below."""
    g = max(channels // 2, 1) if channels <= 32 else 32
    while channels % g != 0:
        g -= 1
    return g


def valid_rows(rows: int, count, device) -> torch.Tensor:
    """(rows,) bool: True on the vertex rows [1, count)."""
    r = torch.arange(rows, device=device)
    return (r > 0) & (r < count)


def masked_group_norm(x: torch.Tensor, valid: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """GroupNorm of (cap, C) ``x`` over the rows where ``valid`` holds, with
    the affine ``weight`` and ``bias``; zero on the other rows."""
    cap, c = x.shape
    groups = gn_num_groups(c)
    cpg = c // groups
    vf = valid.to(torch.float32)[:, None, None]
    n = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    xg = x.reshape(cap, groups, cpg)
    denom = n * cpg
    mean = (xg * vf).sum(dim=(0, 2)) / denom
    var = (((xg - mean[None, :, None]) ** 2) * vf).sum(dim=(0, 2)) / denom
    inv = torch.rsqrt(var + eps)
    y = ((xg - mean[None, :, None]) * inv[None, :, None]).reshape(cap, c)
    y = y * weight + bias
    return torch.where(valid[:, None], y, torch.zeros((), device=x.device))


def masked_gn_relu_plain(x, count, weight, bias, eps):
    """K7's forward in plain PyTorch: ``relu`` of :func:`masked_group_norm`
    over the rows [1, count)."""
    valid = valid_rows(x.shape[0], count, x.device)
    return torch.relu(masked_group_norm(x, valid, weight, bias, eps))


def masked_gn_relu_backward_plain(dy, x, count, weight, bias, eps):
    """K7's backward in plain PyTorch: the gradients (dx, dw, db) of
    :func:`masked_gn_relu_plain` for the cotangent ``dy``, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
        out = masked_gn_relu_plain(leaves[0], count, leaves[1], leaves[2],
                                   eps)
        return torch.autograd.grad(out, leaves, dy)


@functools.lru_cache(maxsize=None)
def _blocks(device_index: int) -> int:
    """K7's grid: two blocks for each SM of the card."""
    return 2 * torch.cuda.get_device_properties(
        device_index).multi_processor_count


_THREADS = 512     # a block's threads (kThreads in csrc/masked_gn.cu)


def _check(x, count, weight, bias, *arrays):
    """K7's checks of x, of the other (rows, C) ``arrays`` and of the
    parameters; returns (count, its pointer, its number, groups, vector
    width, grid)."""
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    for t in (x,) + arrays:
        if (t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != x.shape or t.device != x.device):
            raise ValueError(f"x and dy must be contiguous (rows, C) float32 "
                             f"of one shape, got {tuple(t.shape)} {t.dtype}")
    rows, c = x.shape
    if rows < 1 or c < 1:
        raise ValueError(f"x must have rows and channels, got "
                         f"{tuple(x.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be ({c},) float32 on {x.device}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + arrays)
    vec = 4 if c % 4 == 0 and aligned else 1
    if c // vec > _THREADS:
        raise ValueError(f"K7 takes at most {_THREADS * vec} channels here, "
                         f"got {c}")
    if torch.is_tensor(count):
        if count.numel() != 1 or count.dtype.is_floating_point \
                or count.device != x.device:
            raise ValueError("count must be one integer on x's device")
        count = count.reshape(()).to(torch.int64)
        ptr, imm = count.data_ptr(), 0
    else:
        ptr, imm = None, int(count)
    blocks = min(_blocks(x.device.index if x.device.index is not None
                         else torch.cuda.current_device()),
                 -(-rows // (_THREADS // (c // vec))))
    return count, ptr, imm, gn_num_groups(c), vec, blocks


def masked_gn_relu_forward(x, count, weight, bias, eps):
    """``masked_gn_relu_plain`` as three launches of K7 for a CUDA ``x``;
    the plain version for a CPU one.

    Args:
      x: (rows, C) float32, contiguous.
      count: () integer tensor on x's device, or an int: the valid rows
        are [1, count).
      weight, bias: (C,) float32.
    Returns (out, stats): out (rows, C) float32; stats (2, groups) float32,
    each group's mean and 1 / sqrt(var + eps) (None on the CPU).
    """
    if x.device.type == "cpu":
        return masked_gn_relu_plain(x, count, weight, bias, eps), None
    count, ptr, imm, groups, vec, blocks = _check(x, count, weight, bias)
    rows, c = x.shape
    out = torch.empty_like(x)
    stats = torch.empty((2, groups), dtype=torch.float32, device=x.device)
    work = torch.empty(2 * blocks * groups, dtype=torch.float32,
                       device=x.device)
    fn = _cuda.function("masked_gn", "tln_masked_gn_forward",
                        [_cuda.P, _cuda.P, _cuda.I64, _cuda.P, _cuda.P,
                         _cuda.F32, _cuda.P, _cuda.P, _cuda.P, _cuda.I32,
                         _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
                         _cuda.P])
    err = fn(x.data_ptr(), ptr, imm, weight.data_ptr(), bias.data_ptr(),
             float(eps), out.data_ptr(), stats.data_ptr(), work.data_ptr(),
             rows, c, groups, vec, blocks, _cuda.stream_ptr())
    _cuda.check("masked_gn", err, "masked_gn_relu_forward")
    _cuda.count_launch("masked_gn_relu")
    return out, stats


def masked_gn_relu_backward(dy, x, stats, count, weight, bias, eps):
    """The gradients (dx, dw, db) of ``masked_gn_relu_plain`` as two
    launches of K7 for CUDA tensors, from the forward's ``stats``; the
    plain version (autograd) for CPU ones."""
    if x.device.type == "cpu":
        return masked_gn_relu_backward_plain(dy, x, count, weight, bias, eps)
    dy = dy.contiguous()
    count, ptr, imm, groups, vec, blocks = _check(x, count, weight, bias, dy)
    rows, c = x.shape
    if stats.shape != (2, groups) or not stats.is_contiguous():
        raise ValueError(f"stats must be the forward's (2, {groups})")
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    db = torch.empty_like(bias)
    work = torch.empty(2 * blocks * (c + groups), dtype=torch.float32,
                       device=x.device)
    fn = _cuda.function("masked_gn", "tln_masked_gn_backward",
                        [_cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.P,
                         _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                         _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
                         _cuda.I32, _cuda.P])
    err = fn(x.data_ptr(), dy.data_ptr(), ptr, imm, weight.data_ptr(),
             bias.data_ptr(), stats.data_ptr(), dx.data_ptr(), dw.data_ptr(),
             db.data_ptr(), work.data_ptr(), rows, c, groups, vec, blocks,
             _cuda.stream_ptr())
    _cuda.check("masked_gn", err, "masked_gn_relu_backward")
    _cuda.count_launch("masked_gn_relu_backward")
    return dx, dw, db


class _MaskedGnRelu(torch.autograd.Function):
    """``relu(masked_group_norm(x))`` over the rows [1, count) as K7
    (:func:`masked_gn_relu_forward`, :func:`masked_gn_relu_backward`; their
    plain versions on the CPU).  It saves x, the weight, the bias and the
    forward's per-group mean and inverse deviation, never an array of the
    intermediate values."""

    @staticmethod
    def forward(ctx, x, weight, bias, count, eps):
        out, stats = masked_gn_relu_forward(x, count, weight, bias, eps)
        counted = torch.is_tensor(count)
        ctx.count = None if counted else count
        ctx.eps = eps
        ctx.save_for_backward(x, weight, bias, stats,
                              count if counted else None)
        return out

    @staticmethod
    def backward(ctx, dy):
        with span("tln.backward._MaskedGnRelu"):
            x, weight, bias, stats, count = ctx.saved_tensors
            if count is None:
                count = ctx.count
            dx, dw, db = masked_gn_relu_backward(dy, x, stats, count, weight,
                                                 bias, ctx.eps)
            need = ctx.needs_input_grad
            return (dx if need[0] else None, dw if need[1] else None,
                    db if need[2] else None, None, None)


def masked_gn_relu(x: torch.Tensor, count, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``relu`` of the GroupNorm of ``x`` over its rows [1, count), zero on
    the others: one :class:`_MaskedGnRelu` (kernel K7) on the card, the
    plain version (:func:`masked_gn_relu_plain`) on the CPU."""
    if x.is_cuda:
        return _MaskedGnRelu.apply(x.contiguous(), weight, bias, count, eps)
    return masked_gn_relu_plain(x, count, weight, bias, eps)
