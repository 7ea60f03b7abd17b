"""Frozen copy of the port's ``ops/lattice_ops.py`` (plain PyTorch only: no CUDA
kernel, no import of the port).  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.

Original docstring:

Lattice compute ops (port of the JAX package's ``ops/lattice_ops.py``),
cut to those of the sequence lattice's forward and backward: the one-hop
lattice convolution, the coarsen splat and finefy slice through a level
link, and the deform-slice gather.

Vertex-value arrays are capacity-padded (cap, C) and exactly zero outside
the occupied rows [1, count) (:func:`mask_rows`); gathers through absent
neighbors therefore read zeros without an explicit mask.

The JAX package's three ``custom_vjp``s are ``torch.autograd.Function``s
here, with the same backward: the neighborhood gather's transpose is another
gather (:class:`_Gather8Sym`), the coarsen splat's is the barycentric slice
(:class:`_SplatSorted`), and the finefy slice's is the splat on the link's
dst-sorted view through kernel K2 (:class:`_SliceSorted`).  The deform
slice's row gather (:class:`_GatherRows`) adds its backward with
:func:`segment_sum`, which spreads the rows that read the invalid row 0
before it adds them.  Barycentric weights get no gradient (nothing
differentiates point positions).  The JAX package's float32
``segment_sum`` is :func:`segment_sum`, which gives the same bits on every
call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .seg_scan import sorted_segment_scan
from .vertex_table import PACKED_SENTINEL


@dataclasses.dataclass
class DistributeOut:
    """One frame's (or all frames') splat rows: row r of the flattened
    (P*4) arrays is (point r // 4, simplex vertex r % 4)."""

    row_vertex: torch.Tensor     # (..., P*4) int64 stable vertex index (0 = invalid)
    row_bary: torch.Tensor       # (..., P*4) float32 (0 for invalid rows)
    row_rel_pos: torch.Tensor    # (..., P*4, 3) float32
    row_valid: torch.Tensor      # (..., P*4) bool
    point_vertex: torch.Tensor   # (..., P, 4) int64
    point_bary: torch.Tensor     # (..., P, 4) float32

    def frame(self, t: int) -> "DistributeOut":
        return DistributeOut(*(getattr(self, f.name)[t]
                               for f in dataclasses.fields(self)))


class NeighborTable(NamedTuple):
    """One-hop adjacency: ``idx[:, :8]`` neighbors (0 where absent), in
    ``neighbor_offsets`` order (``gather8_sym``'s backward and AFlow's taps
    depend on it), ``idx[:, 8]`` the vertex itself (center last)."""

    idx: torch.Tensor    # (C, 9) int64
    found: torch.Tensor  # (C, 9) bool


@dataclasses.dataclass
class LevelLink:
    """Barycentric coupling of a fine level to the next coarser one, with
    its dst-sorted splat view (:func:`augment_link_sorted`)."""

    corner_idx: torch.Tensor    # (Cf, 4) int64 coarse indices
    corner_bary: torch.Tensor   # (Cf, 4) float32
    sorted_src: torch.Tensor | None = None  # (Cf*4,) int64 fine row per entry
    sorted_w: torch.Tensor | None = None    # (Cf*4,) float32 bary per entry
    sorted_dst: torch.Tensor | None = None  # (Cf*4,) int32 nondecreasing dst
    tailpos: torch.Tensor | None = None     # (Cc,) int64 last entry position
    tail_live: torch.Tensor | None = None   # (Cc,) bool dst has entries


_SPREAD = 1024   # rows that take segment 0's rows in segment_sum (2**10)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sums of the rows of ``data`` (the JAX package's
    ``segment_sum``, ``jax.ops.segment_sum``): ids outside
    ``[0, num_segments)`` are dropped.  The same bits on every call and on
    either device: each segment's rows are added in row order.  On the CPU
    that is ``index_add_``; on CUDA ``index_add_`` would add with atomics,
    in an order that changes from run to run, so ``index_put_`` with
    ``accumulate`` sorts the ids and adds each segment's rows in turn.

    Segment 0 is the reserved invalid bucket, which holds every masked
    point's rows (tens of thousands a frame).  The sorted accumulate would
    add them one after another, so row ``r`` of segment 0 goes to spare row
    ``r % _SPREAD`` instead, and the spare rows are then added pairwise,
    halving their count each time (a fixed order on both devices)."""
    q = segment_ids.shape[0]
    spread = num_segments + (torch.arange(q, device=segment_ids.device)
                             % _SPREAD)
    drop = num_segments + _SPREAD
    ids = torch.where(segment_ids == 0, spread, segment_ids)
    ids = torch.where((segment_ids < 0) | (segment_ids >= num_segments),
                      drop, ids)
    out = torch.zeros((drop + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if data.is_cuda:
        out.index_put_((ids,), data, accumulate=True)
    else:
        out.index_add_(0, ids, data)
    zero = out[num_segments:drop]
    while zero.shape[0] > 1:
        half = zero.shape[0] // 2
        zero = zero[:half] + zero[half:]
    return torch.cat([zero, out[1:num_segments]])


def mask_rows(values: torch.Tensor, count) -> torch.Tensor:
    """Zero all rows >= count and the reserved row 0."""
    rows = torch.arange(values.shape[0], device=values.device)
    keep = (rows < count) & (rows > 0)
    return torch.where(keep[:, None], values, torch.zeros((), dtype=values.dtype,
                                                          device=values.device))


# adjoint tap pairing: neighbor_offsets lists [+o_0..+o_d, -o_0..-o_d], so
# "i sees j at tap k" <=> "j sees i at tap (k + d+1) % 2(d+1)"
_PAIR_3D = tuple((k + 4) % 8 for k in range(8))


class _Gather8Sym(torch.autograd.Function):
    """Neighborhood gather (C, 8, Cin) whose backward is another gather
    (``lattice_ops._gather8_sym``): the one-hop offsets come in +/- pairs,
    so "who reads row j at tap k" is ``idx8[j, pair(k)]``, and the
    cotangent is one flat gather through the same table at
    ``inv * 8 + tap``, summed over taps in float32.  Requires idx8 in
    neighbor_offsets order and zero cotangents at rows 0 and >= count
    upstream (the ``mask_rows`` invariant)."""

    @staticmethod
    def forward(ctx, values, idx8):
        ctx.save_for_backward(idx8)
        return values[idx8]

    @staticmethod
    def backward(ctx, dg):
        (idx8,) = ctx.saved_tensors
        cap, taps, cin = dg.shape
        inv = idx8[:, list(_PAIR_3D)]
        fi = inv * taps + torch.arange(taps, device=idx8.device)[None, :]
        g = dg.reshape(cap * taps, cin)[fi]
        acc = torch.where((inv > 0)[..., None], g.to(torch.float32),
                          torch.zeros((), device=dg.device)).sum(dim=1)
        return acc.to(dg.dtype), None


def gather8_sym(values: torch.Tensor, idx8: torch.Tensor) -> torch.Tensor:
    """``values[idx8]`` for a (C, 8) one-hop table over the same C rows,
    with the gather-adjoint backward of :class:`_Gather8Sym`."""
    if idx8.shape != (values.shape[0], 8):
        raise ValueError(f"gather8_sym: idx8 must be ({values.shape[0]}, 8), "
                         f"got {tuple(idx8.shape)}")
    return _Gather8Sym.apply(values, idx8)


class _GatherRows(torch.autograd.Function):
    """``values[idx]`` whose backward is :func:`segment_sum` of the
    cotangent rows by ``idx``: each row's contributions added in row order,
    and the rows that read row 0 (every masked point reads the invalid
    bucket) spread over spare rows instead of forming one serial chain."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.rows = values.shape[0]
        return values[idx]

    @staticmethod
    def backward(ctx, dg):
        (idx,) = ctx.saved_tensors
        flat = dg.reshape((idx.numel(),) + tuple(dg.shape[idx.dim():]))
        return segment_sum(flat, idx.reshape(-1), ctx.rows), None


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` with the backward of :class:`_GatherRows`."""
    return _GatherRows.apply(values, idx)


def gather_rowified(values: torch.Tensor, nbr: NeighborTable) -> torch.Tensor:
    """Im2row: (C, 9*Cin) neighborhood features, center last.  The center
    tap is the row itself, so it is concatenated instead of gathered."""
    cap = values.shape[0]
    g = gather8_sym(values, nbr.idx[:, :8])
    g = torch.cat([g, values[:, None, :]], dim=1)
    return g.reshape(cap, -1)


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` with operands rounded to ``compute_dtype`` and a float32
    product: the JAX package's ``jnp.dot(a.astype(cd), w.astype(cd),
    preferred_element_type=float32)``.  A bf16 ``torch.matmul`` would round
    its result to bf16, so the rounded operands are upcast (exactly) and
    multiplied in float32."""
    if compute_dtype != torch.float32:
        x = round_to(x, compute_dtype)
        w = round_to(w, compute_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the operand precision ``dtype``: bf16 as the port
    casts it; float8_e4m3fn (the precision control) with one scale per
    tensor, its amax mapped to the format's largest value, held in float32
    and differentiated straight through."""
    if dtype == torch.float8_e4m3fn:
        xf = x.to(torch.float32)
        scale = xf.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (xf.detach() / scale).to(dtype).to(torch.float32) * scale
        return xf + (q - xf.detach())
    return x.to(dtype)


def _gather_matmul(values, nbr, weight, compute_dtype):
    return matmul_f32(gather_rowified(values, nbr), weight, compute_dtype)


def lattice_conv(values: torch.Tensor, nbr: NeighborTable,
                 weight: torch.Tensor, count, bias=None,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hop lattice convolution: gather -> (C, 9*Cin) @ (9*Cin, Cout)."""
    values = round_to(values, compute_dtype)
    out = _gather_matmul(values, nbr, weight, compute_dtype)
    if bias is not None:
        out = out + bias
    return mask_rows(out, count)


def augment_link_sorted(corner_idx: torch.Tensor, corner_bary: torch.Tensor,
                        coarse_cap: int) -> LevelLink:
    """The LevelLink of ``corner_idx``/``corner_bary`` with its dst-sorted
    splat view.

    Entries are stably sorted by coarse destination; each destination's last
    entry position is recorded by a tail compaction.  As in the JAX package,
    the compaction's unused entries carry index -1, which its scatter wraps
    to the LAST slot: when there are fewer destinations than
    ``min(coarse_cap, Cf*4)``, slot ``coarse_cap - 1`` gets ``tail_live``
    True and the last unused entry's position.  Reproduced here; it is
    harmless because ``mask_rows`` zeros that row unless the coarse table
    is full."""
    cf, dp1 = corner_idx.shape
    n = cf * dp1
    dev = corner_idx.device
    dst = corner_idx.reshape(-1)
    order = torch.sort(dst, stable=True).indices
    d_s = dst[order]
    w_s = corner_bary.reshape(-1)[order]
    tail = torch.ones(n, dtype=torch.bool, device=dev)
    tail[:-1] = d_s[1:] != d_s[:-1]
    hk = torch.where(tail, d_s, torch.full_like(d_s, PACKED_SENTINEL))
    p_t = torch.sort(hk, stable=True).indices
    d_t = hk[p_t]
    m = min(coarse_cap, n)
    dd, pp = d_t[:m], p_t[:m]
    real = dd != PACKED_SENTINEL
    tp = torch.zeros(coarse_cap, dtype=torch.int64, device=dev)
    live = torch.zeros(coarse_cap, dtype=torch.bool, device=dev)
    tp[dd[real]] = pp[real]
    live[dd[real]] = True
    if m > 0:
        wrapped = ~real[-1]          # an unused entry exists -> last slot
        tp[-1] = torch.where(wrapped, pp[-1], tp[-1])
        live[-1] = live[-1] | wrapped
    return LevelLink(corner_idx=corner_idx, corner_bary=corner_bary,
                     sorted_src=order // dp1, sorted_w=w_s,
                     sorted_dst=d_s.to(torch.int32), tailpos=tp,
                     tail_live=live)


def _splat_sorted_impl(fine_values: torch.Tensor,
                       link: LevelLink) -> torch.Tensor:
    """Gather the dst-sorted entries, one segmented sum over them (kernel
    K2), and read each destination's total at its tail entry."""
    rows = (fine_values[link.sorted_src] * link.sorted_w[:, None]).contiguous()
    scanned = sorted_segment_scan(link.sorted_dst, rows, "sum")
    return scanned[link.tailpos] * link.tail_live[:, None]


def _slice_impl(coarse_values: torch.Tensor, link: LevelLink) -> torch.Tensor:
    g = coarse_values[link.corner_idx]                       # (Cf, 4, C)
    return torch.einsum("fvc,fv->fc", g, link.corner_bary)


class _SplatSorted(torch.autograd.Function):
    """The coarsen splat (K2 forward); it is linear in the fine values, and
    its exact transpose, the backward, is the barycentric slice: a gather,
    never a scatter."""

    @staticmethod
    def forward(ctx, fine_values, link):
        ctx.link = link
        return _splat_sorted_impl(fine_values, link)

    @staticmethod
    def backward(ctx, d_out):
        return _slice_impl(d_out, ctx.link), None


class _SliceSorted(torch.autograd.Function):
    """The finefy slice (a gather forward); its transpose, the backward, is
    the barycentric splat on the link's dst-sorted view through kernel K2
    (``lattice_ops._slice_sorted_bwd``)."""

    @staticmethod
    def forward(ctx, coarse_values, link):
        ctx.link = link
        return _slice_impl(coarse_values, link)

    @staticmethod
    def backward(ctx, d_fine):
        return _splat_sorted_impl(d_fine, ctx.link), None


def splat_to_coarse(fine_values: torch.Tensor,
                    link: LevelLink) -> torch.Tensor:
    """Barycentric splat of fine vertex features onto the coarse level: a
    segmented sum (the port's K2) on the link's dst-sorted view, whose size
    is the coarse capacity.  Returns (Cc, C)."""
    return _SplatSorted.apply(fine_values, link)


def slice_to_fine(coarse_values: torch.Tensor, link: LevelLink) -> torch.Tensor:
    """Barycentric slice of coarse features back onto the fine vertices;
    ``coarse_values`` has the link's Cc rows."""
    if coarse_values.shape[0] != link.tailpos.shape[0]:
        raise ValueError(f"slice_to_fine: {coarse_values.shape[0]} coarse rows "
                         f"for a link of {link.tailpos.shape[0]}")
    return _SliceSorted.apply(coarse_values, link)


