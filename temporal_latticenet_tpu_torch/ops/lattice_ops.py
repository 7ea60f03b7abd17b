"""Lattice compute ops (port of the JAX package's ``ops/lattice_ops.py``):
the streaming path's per-frame structures (distribute onto a vertex table,
neighbor tables, coarse tables and links, each built in full or updated
incrementally), the one-hop lattice convolution, the coarsen splat and
finefy slice through a level link, and the deform-slice gather.

Vertex-value arrays are capacity-padded (cap, C) and exactly zero outside
the occupied rows [1, count) (:func:`mask_rows`); gathers through absent
neighbors therefore read zeros without an explicit mask.

The JAX package's three ``custom_vjp``s are ``torch.autograd.Function``s
here, with the same backward: the neighborhood gather's transpose is another
gather (:class:`_Gather8Sym`), the coarsen splat's is the barycentric slice
(:class:`_SplatSorted`), and the finefy slice's is the splat on the link's
dst-sorted view through kernel K2 (:class:`_SliceSorted`).  The deform
slice's row gather (:class:`_GatherRows`) adds its backward with
:func:`segment_sum`, which leaves out the rows that read the invalid row
0.  Barycentric weights get no gradient (nothing differentiates point
positions).  The streaming path's links have no dst-sorted view: their
splat is a float32 :func:`segment_sum` and their slice a plain gather.

The streaming structures keep every count on the device; nothing in a frame
reads a tensor on the host.  ``.at[...].set(..., mode="drop")`` of the JAX
package becomes a write into a copy with one extra drop row, and its
float32 ``segment_sum`` is :func:`segment_sum`, which gives the same bits
on every call.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import permutohedral as pm
from .fused_simplex import fused_simplex_pack
from .seg_scan import sorted_segment_scan
from .vertex_table import (PACKED_SENTINEL, SENTINEL, VertexTable, lookup,
                           scatter_or_drop, union_and_index,
                           union_and_index_packed)


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
    """Barycentric coupling of a fine level to the next coarser one; the
    offline path adds its dst-sorted splat view (:func:`augment_link_sorted`),
    the streaming path's links have none."""

    corner_idx: torch.Tensor    # (Cf, 4) int64 coarse indices
    corner_bary: torch.Tensor   # (Cf, 4) float32
    sorted_src: torch.Tensor | None = None  # (Cf*4,) int64 fine row per entry
    sorted_w: torch.Tensor | None = None    # (Cf*4,) float32 bary per entry
    sorted_dst: torch.Tensor | None = None  # (Cf*4,) int32 nondecreasing dst
    tailpos: torch.Tensor | None = None     # (Cc,) int64 last entry position
    tail_live: torch.Tensor | None = None   # (Cc,) bool dst has entries


@dataclasses.dataclass
class FrameStructures:
    """One frame's lattice structures on the streaming incremental path,
    built by the engine between frames and handed to the model.

    ``overflowed`` turns True once a frame's growth at some level exceeded
    the incremental update's ``max_new`` bound: the vertices beyond it have
    no adjacency or link rows, for good (the tables are append-only), so
    the results are degraded.  It stays True for the rest of the sequence;
    callers check it and rebuild in full or with a larger bound."""

    nbrs: tuple                 # NeighborTable per level
    links: tuple                # LevelLink per downsample
    counts: tuple               # () int64 per level
    overflowed: torch.Tensor    # () bool


_SPREAD = 1024   # rows that take segment 0's rows in segment_sum


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sums of the rows of ``data`` (the JAX package's
    ``segment_sum``), the same bits on every call and on either device:
    each segment's rows are added in row order.  On the CPU that is
    ``index_add_``; on CUDA ``index_add_`` would add with atomics, in an
    order that changes from run to run, so ``index_put_`` with
    ``accumulate`` sorts the ids and adds each segment's rows in turn.

    Segment 0 is the reserved invalid bucket, whose rows carry zero weight
    or whose sum is masked by every caller: its rows are left out and its
    sum is 0.  They go to ``_SPREAD`` extra rows instead, because the
    sorted accumulate adds one segment's rows one after another, and the
    bucket holds every masked point's rows (tens of thousands a frame)."""
    q = segment_ids.shape[0]
    spread = num_segments + (torch.arange(q, device=segment_ids.device)
                             % _SPREAD)
    ids = torch.where(segment_ids > 0, segment_ids, spread)
    out = torch.zeros((num_segments + _SPREAD,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if data.is_cuda:
        out.index_put_((ids,), data, accumulate=True)
    else:
        out.index_add_(0, ids, data)
    return out[:num_segments]


def distribute(table: VertexTable, positions: torch.Tensor,
               point_mask: torch.Tensor, sigma: float):
    """Splat one frame's points onto the lattice, growing the (carried)
    vertex table append-only.

    Keys and weights come from kernel K1 (``fused_simplex_pack``; its plain
    version for CPU tensors), which computes the JAX package's ``elevate``
    + ``find_enclosing_simplex`` + ``pack_keys`` bit for bit.  The local
    mean is a float32 :func:`segment_sum` of (xyz * w, w) per vertex, and
    every row's position is taken relative to its vertex's mean (the
    no-local-mean experiments are not ported).

    Args:
      positions: (P, 3) float32, zero-padded; point_mask: (P,) bool.
    Returns ``(new_table, DistributeOut)`` with (P*4,) row fields.
    """
    p = positions.shape[0]
    y = pm.scale_positions(positions, sigma).contiguous()
    packed4, bary4 = fused_simplex_pack(y, point_mask.contiguous())
    new_table, row_vertex = union_and_index_packed(table, packed4.reshape(-1))

    row_valid = point_mask.repeat_interleave(4) & (row_vertex > 0)
    row_bary = torch.where(row_valid, bary4.reshape(-1),
                           torch.zeros((), device=bary4.device))
    pos_rows = positions.to(torch.float32).repeat_interleave(4, dim=0)
    w = row_valid.to(torch.float32)
    s = segment_sum(torch.cat([pos_rows * w[:, None], w[:, None]], dim=1),
                    row_vertex, table.capacity)
    mean = s[:, :3] / torch.clamp(s[:, 3:], min=1.0)
    rel = (pos_rows - mean[row_vertex]) * w[:, None]
    return new_table, DistributeOut(
        row_vertex=row_vertex, row_bary=row_bary, row_rel_pos=rel,
        row_valid=row_valid, point_vertex=row_vertex.reshape(p, 4),
        point_bary=row_bary.reshape(p, 4))


def _nbr_rows(table: VertexTable, rows: torch.Tensor, in_table: torch.Tensor):
    """Adjacency rows of the stable slots ``rows``: all eight offset keys
    looked up, the center last; rows outside ``in_table`` find nothing.
    Returns (idx (R, 9), found (R, 9), hit (R, 8) stable index or -1)."""
    keys = table.keys[rows]
    offs = pm.neighbor_offsets_tensor(3, keys.device)
    n_off = offs.shape[0]
    queries = (keys[:, None, :].to(torch.int64) + offs[None]).reshape(-1, 3)
    hit = lookup(table, queries).reshape(-1, n_off)
    hit = torch.where(in_table[:, None], hit, torch.full_like(hit, -1))
    valid_self = in_table & (keys[:, 0] != SENTINEL)
    idx = torch.cat([hit.clamp(min=0), rows[:, None]], dim=1)
    found = torch.cat([hit >= 0, valid_self[:, None]], dim=1) \
        & valid_self[:, None]
    return idx, found, hit


def build_neighbor_table(table: VertexTable) -> NeighborTable:
    """Every vertex's one-hop adjacency by a batched binary search of all
    eight offset keys; one build per level per frame."""
    cap = table.capacity
    rows = torch.arange(cap, device=table.keys.device)
    idx, found, _ = _nbr_rows(table, rows, torch.ones_like(rows, dtype=bool))
    return NeighborTable(idx=idx, found=found)


def update_neighbor_table(table: VertexTable, nbr: NeighborTable, old_count,
                          max_new: int) -> NeighborTable:
    """Extend a NeighborTable after an append-only union: look up rows only
    for the (at most ``max_new``) new vertices, then write the reverse taps
    of their found neighbors (key_v + off[a] == key_j implies key_j +
    off[(a + 4) % 8] == key_v) through the flat (cap * 9) view.  New-new
    pairs are written from both sides alike; old-old pairs are untouched.
    Rows past ``max_new`` new vertices get no update (the engine's sticky
    ``overflowed`` flag reports it).

    Args:
      table: the table after the union; nbr: adjacency valid for the first
        ``old_count`` slots; old_count: () count before the union.
    """
    cap = table.capacity
    dev = table.keys.device
    n_off = nbr.idx.shape[1] - 1
    rows = old_count + torch.arange(max_new, device=dev)
    rows_c = rows.clamp(max=cap - 1)
    in_new = rows < table.count
    idx_rows, found_rows, hit = _nbr_rows(table, rows_c, in_new)
    dst = torch.where(in_new, rows_c, torch.full_like(rows_c, cap))
    idx = scatter_or_drop(nbr.idx, dst, idx_rows)
    found = scatter_or_drop(nbr.found, dst, found_rows)

    rev_tap = (torch.arange(n_off, device=dev) + n_off // 2) % n_off
    j = torch.where(hit >= 0, hit, torch.full_like(hit, cap))
    flat_dst = (j * (n_off + 1) + rev_tap[None, :]).reshape(-1)
    flat_dst = flat_dst.clamp(max=cap * (n_off + 1))
    v_src = rows_c[:, None].expand(-1, n_off).reshape(-1)
    idx = scatter_or_drop(idx.reshape(-1), flat_dst, v_src).reshape(
        cap, n_off + 1)
    found = scatter_or_drop(found.reshape(-1), flat_dst,
                            torch.ones_like(flat_dst, dtype=torch.bool)
                            ).reshape(cap, n_off + 1)
    return NeighborTable(idx=idx, found=found)


def _coarse_corners(keys: torch.Tensor, valid: torch.Tensor):
    """The coarse simplex of every fine key: the key is its elevated
    position, so key * 0.5 lies on the coarse hyperplane.  Returns (corner
    keys (R, 4, 3), bary (R, 4)).  Invalid rows are zeroed first (the
    float-to-int conversion of sentinel-sized keys is undefined)."""
    key_f = torch.where(valid[:, None], keys,
                        torch.zeros((), dtype=keys.dtype, device=keys.device)
                        ).to(torch.float32)
    full = torch.cat([key_f, -key_f.sum(-1, keepdim=True)], dim=-1)
    return pm.find_enclosing_simplex(full * 0.5)


def _corner_link(coarse_table, ckeys, cbary, valid):
    new_coarse, flat_idx = union_and_index(
        coarse_table, ckeys.reshape(-1, 3), valid.repeat_interleave(4))
    corner_idx = flat_idx.reshape(-1, 4)
    corner_bary = torch.where(valid[:, None] & (corner_idx > 0), cbary,
                              torch.zeros((), device=cbary.device))
    return new_coarse, corner_idx, corner_bary


def grow_coarse_table(fine_table: VertexTable, coarse_table: VertexTable):
    """Union every fine vertex's coarse-simplex corners into the carried
    coarse table (append-only, so coarse indices are stable across frames)
    and return ``(new_coarse, LevelLink)`` without a sorted view."""
    valid = fine_table.keys[:, 0] != SENTINEL
    ckeys, cbary = _coarse_corners(fine_table.keys, valid)
    new_coarse, corner_idx, corner_bary = _corner_link(coarse_table, ckeys,
                                                       cbary, valid)
    return new_coarse, LevelLink(corner_idx=corner_idx,
                                 corner_bary=corner_bary)


def grow_coarse_table_incremental(fine_table: VertexTable,
                                  coarse_table: VertexTable, old_fine_count,
                                  link: LevelLink, max_new: int):
    """Incremental :func:`grow_coarse_table`: union only the corners of the
    (at most ``max_new``) new fine vertices and patch their rows into the
    carried link; old fine vertices' corners do not change."""
    cap = fine_table.capacity
    rows = old_fine_count + torch.arange(max_new,
                                         device=fine_table.keys.device)
    rows_c = rows.clamp(max=cap - 1)
    in_new = rows < fine_table.count
    keys = fine_table.keys[rows_c]
    valid = in_new & (keys[:, 0] != SENTINEL)
    ckeys, cbary = _coarse_corners(keys, valid)
    new_coarse, corner_idx, corner_bary = _corner_link(coarse_table, ckeys,
                                                       cbary, valid)
    dst = torch.where(in_new, rows_c, torch.full_like(rows_c, cap))
    return new_coarse, LevelLink(
        corner_idx=scatter_or_drop(link.corner_idx, dst, corner_idx),
        corner_bary=scatter_or_drop(link.corner_bary, dst, corner_bary))


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
    bucket) left out instead of forming one serial chain.  Row 0's gradient
    is therefore 0, which is exact only where nothing upstream uses it: the
    ``mask_rows`` invariant (``values`` comes out of ``mask_rows``, whose
    backward zeroes row 0)."""

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
    """``values[idx]`` for rows of a ``mask_rows``-clean array, with the
    backward of :class:`_GatherRows` (row 0's gradient is dropped)."""
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
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


_REMAT_CONV_ROWS = contextvars.ContextVar("remat_conv_rows", default=False)


@contextlib.contextmanager
def remat_conv_rows(enabled: bool = True):
    """Within this context (and with gradients on), every
    :func:`lattice_conv` recomputes its (C, 9*Cin) rowified rows in the
    backward instead of saving them: the JAX package's selective remat
    (``save_anything_except_these_names("lattice_conv_rows")``)."""
    token = _REMAT_CONV_ROWS.set(enabled)
    try:
        yield
    finally:
        _REMAT_CONV_ROWS.reset(token)


def _gather_matmul(values, nbr, weight, compute_dtype):
    return matmul_f32(gather_rowified(values, nbr), weight, compute_dtype)


def lattice_conv(values: torch.Tensor, nbr: NeighborTable,
                 weight: torch.Tensor, count, bias=None,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hop lattice convolution: gather -> (C, 9*Cin) @ (9*Cin, Cout)."""
    values = values.to(compute_dtype)
    if _REMAT_CONV_ROWS.get() and torch.is_grad_enabled():
        # no randomness inside: the rng state need not be kept
        out = checkpoint(_gather_matmul, values, nbr, weight,
                         compute_dtype, use_reentrant=False,
                         preserve_rng_state=False)
    else:
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


def splat_to_coarse(fine_values: torch.Tensor, link: LevelLink,
                    coarse_cap: int | None = None) -> torch.Tensor:
    """Barycentric splat of fine vertex features onto the coarse level:
    K2 on the link's dst-sorted view (whose size is the coarse capacity),
    or, for a link without one, a float32 :func:`segment_sum` into
    ``coarse_cap`` rows.  Returns (Cc, C)."""
    if link.sorted_src is not None:
        return _SplatSorted.apply(fine_values, link)
    if coarse_cap is None:
        raise ValueError("splat_to_coarse: a link without a sorted view "
                         "needs coarse_cap")
    contrib = fine_values[:, None, :] * link.corner_bary[..., None]
    return segment_sum(contrib.reshape(-1, fine_values.shape[-1]),
                       link.corner_idx.reshape(-1), coarse_cap)


def slice_to_fine(coarse_values: torch.Tensor, link: LevelLink) -> torch.Tensor:
    """Barycentric slice of coarse features back onto the fine vertices;
    ``coarse_values`` has the link's Cc rows.  Without a sorted view the
    slice is the plain gather (and its backward autograd's)."""
    if link.sorted_src is None:
        return _slice_impl(coarse_values, link)
    if coarse_values.shape[0] != link.tailpos.shape[0]:
        raise ValueError(f"slice_to_fine: {coarse_values.shape[0]} coarse rows "
                         f"for a link of {link.tailpos.shape[0]}")
    return _SliceSorted.apply(coarse_values, link)


def slice_gather(values: torch.Tensor, point_vertex: torch.Tensor,
                 point_bary: torch.Tensor) -> torch.Tensor:
    """Per point, its simplex-vertex features weighted by ``point_bary``."""
    g = values[point_vertex]
    return torch.einsum("pvc,pv->pc", g, point_bary)
