"""Segment reductions of the pointnet (port of the JAX package's
``ops/segment.py``): the packed value + barycentric-weight max
``sorted_packed_max`` and ``segment_max_with_bary_packed``, each with its
straight-through backward, the float32 ``segment_max_with_argmax``, and
``segment_mean`` (the ``splat`` experiment's reduction).

The bf16 value bits (monotone-mapped) go into the high 16 bits of a uint32
and the quantised barycentric weight into the low 16, so one segmented
running max carries both; each bucket's result is read at its tail row.
The uint32 bits are held in int32 tensors.

The per-frame max (:func:`segment_max_with_bary_packed`: streaming, and the
non-batched offline route in bf16) is one ``scatter_reduce("amax")`` of the
packed values, as uint32 in int64, from a zero fill; in float32 the
per-frame route takes :func:`segment_max_with_argmax` instead.  The offline
path's max over contiguous sorted sub-runs (:func:`sorted_packed_max`)
takes one of two routes, bit-equal at the tails (max does not depend on
order):

* the default: one full-run segmented max (kernel K4) read at the tails;
* with ``TLN_MAXSCAN_PACKED=1`` in the environment (read at call time, the
  JAX package's own switch) and C <= 64: the two-level tail max, a windowed
  max (kernel K5) plus a full-run max over one chunk-end summary row per
  16 rows (K4) and a correction (:func:`_seg_max_tails_twolevel`).
"""

from __future__ import annotations

import os

import torch

from .lattice_ops import segment_sum
from .seg_scan import INT_MIN, sorted_segment_max_u32, sorted_segment_max_window

CHUNK = 16   # rows per chunk of the two-level tail max (window CHUNK // 2)


def _packed_route() -> bool:
    """True when ``TLN_MAXSCAN_PACKED=1``: C <= 64 maxima take the two-level
    route on K5 (the JAX package reads the same variable at call time)."""
    return os.environ.get("TLN_MAXSCAN_PACKED", "0") == "1"


def _pack_value_bary(data: torch.Tensor, bary: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """(Q, C) int32 holding uint32 bits: monotone bf16 bits << 16 |
    round(bary * 65535); 0 for dead rows (the uint32 max identity)."""
    bits = data.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    mono = torch.where(bits >= 0x8000, bits ^ 0xFFFF, bits | 0x8000)
    # the high half as a signed 16-bit value, so the product below cannot
    # overflow int32
    hi = torch.where(mono >= 0x8000, mono - 0x10000, mono)
    b16 = (torch.clamp(bary, 0.0, 1.0) * 65535.0 + 0.5).to(torch.int32)
    packed = hi * 0x10000 + b16[:, None]
    return torch.where(live[:, None], packed, torch.zeros_like(packed))


def _decode_packed(best: torch.Tensor):
    """(B, C) uint32 bits, held in int32 or int64 -> (max (B, C) float32,
    bary (B, C))."""
    has = best != 0
    mono = (best >> 16) & 0xFFFF
    bits = torch.where(mono >= 0x8000, mono ^ 0x8000, mono ^ 0xFFFF)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    mx = bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)
    mx = torch.where(has, mx, torch.zeros_like(mx))
    bary_sel = torch.where(has, (best & 0xFFFF).to(torch.float32) / 65535.0,
                           torch.zeros_like(mx))
    return mx, bary_sel


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max of int32 tensors compared as uint32."""
    flip = torch.tensor(INT_MIN, dtype=torch.int32, device=a.device)
    return torch.maximum(a ^ flip, b ^ flip) ^ flip


def _seg_max_tails_twolevel(head_count: torch.Tensor, packed: torch.Tensor,
                            tails: torch.Tensor,
                            chunk: int = CHUNK) -> torch.Tensor:
    """Per-tail run max from a windowed max plus chunk-summary correction
    (the JAX package's ``segment._seg_max_tails_twolevel``).

    The windowed max (K5, window ``chunk // 2``) makes every row cover its
    last ``chunk`` same-run rows, so chunk-end rows hold their whole chunk
    and consecutive chunk-end summaries tile a long run back to its head.
    A full-run max over the Q / chunk summaries (K4) then gives, at the
    last chunk end before each tail, the max over everything the tail's
    window misses:

        tail max = max(capped[tail], scanned_summary[tail // chunk - 1])

    with the correction dropped when that chunk end lies in an earlier run
    or the tail sits in chunk 0.  Q is padded to a multiple of ``chunk``
    with rows of fresh run ids.
    """
    q, c = packed.shape
    hc = head_count
    qp = -(-q // chunk) * chunk
    if qp != q:
        pad = qp - q
        packed = torch.cat([packed, torch.zeros((pad, c), dtype=packed.dtype,
                                                device=packed.device)])
        hc = torch.cat([hc, hc[-1] + torch.arange(1, pad + 1, dtype=hc.dtype,
                                                  device=hc.device)])
    capped = sorted_segment_max_window(hc, packed, chunk // 2)
    summ = capped[chunk - 1::chunk].contiguous()
    summ_ids = hc[chunk - 1::chunk].contiguous()
    scanned = sorted_segment_max_u32(summ_ids, summ)
    base = capped[tails]
    e_chunk = tails // chunk - 1
    e_row = e_chunk.clamp(min=0) * chunk + chunk - 1
    ok = (e_chunk >= 0) & (hc[e_row] == hc[tails])
    corr = torch.where(ok[:, None], scanned[e_chunk.clamp(min=0)],
                       torch.zeros((), dtype=packed.dtype, device=packed.device))
    return _umax(base, corr)


class _SortedPackedMax(torch.autograd.Function):
    """Forward: the packed max read at the bucket tails.  Backward: the
    straight-through max gradient of ``segment._sorted_packed_max_bwd``:
    each bucket/channel cotangent flows to the rows whose packed value
    equals the bucket's best, by one gather by bucket id."""

    @staticmethod
    def forward(ctx, data, bary, live, head_count, bucket, tailpos,
                bucket_live):
        packed = _pack_value_bary(data, bary, live)
        tails = tailpos.reshape(-1)
        if packed.shape[1] <= 64 and _packed_route():
            best = _seg_max_tails_twolevel(head_count, packed, tails)
        else:
            best = sorted_segment_max_u32(head_count, packed)[tails]
        best = torch.where(bucket_live.reshape(-1, 1), best,
                           torch.zeros_like(best))
        ctx.save_for_backward(packed, best, bucket)
        ctx.data_dtype = data.dtype
        return _decode_packed(best)

    @staticmethod
    def backward(ctx, dmx, dbary_sel):
        packed, best, bucket = ctx.saved_tensors
        nb, c = best.shape

        def pad(a):
            return torch.cat([a, torch.zeros((1, c), dtype=a.dtype,
                                             device=a.device)])

        b = bucket.clamp(max=nb)
        sel_best = pad(best)[b]
        winner = (packed == sel_best) & (sel_best != 0)
        zero = torch.zeros((), dtype=dmx.dtype, device=dmx.device)
        ddata = torch.where(winner, pad(dmx)[b], zero).to(ctx.data_dtype)
        dbary = None
        if ctx.needs_input_grad[1]:
            dbary = torch.where(winner, pad(dbary_sel)[b], zero).sum(-1)
        return ddata, dbary, None, None, None, None, None


def sorted_packed_max(data, bary, live, head_count, bucket, tailpos,
                      bucket_live):
    """Packed value + bary segment max over contiguous sorted sub-runs.

    Args:
      data: (Q, C) rows in sorted order (cast to bf16 for packing); the
        gradient flows to it straight through the winning rows.
      bary: (Q,) float32; live: (Q,) bool.
      head_count: (Q,) int32 sub-run ids (nondecreasing).
      bucket: (Q,) int64 bucket id per row (``T * cap`` for dead rows), for
        the backward's gather.
      tailpos: (B,) or (T, cap) int64 sorted position of each bucket tail.
      bucket_live: matching bool, False for empty buckets.
    Returns (mx (B, C) float32, bary_sel (B, C) float32).
    """
    return _SortedPackedMax.apply(data, bary, live, head_count, bucket,
                                  tailpos, bucket_live)


class _SegmentMaxPacked(torch.autograd.Function):
    """Forward: the packed scatter max of :func:`segment_max_with_bary_packed`.
    Backward: the straight-through max gradient of the JAX package's
    ``segment._packed_max_bwd``: each segment/channel cotangent flows to the
    rows whose packed value equals the segment's best, by one gather by
    segment id (no scatter)."""

    @staticmethod
    def forward(ctx, data, bary, segment_ids, num_segments, valid):
        packed = _pack_value_bary(data, bary, valid)
        best = torch.zeros((num_segments, packed.shape[1]), dtype=torch.int64,
                           device=packed.device).scatter_reduce_(
            0, segment_ids[:, None].expand_as(packed),
            packed.to(torch.int64) & 0xFFFFFFFF, "amax")
        # the int32 words are kept and widened in the backward, so the
        # forward launches nothing for it
        ctx.save_for_backward(packed, best, segment_ids)
        ctx.data_dtype = data.dtype
        return _decode_packed(best)

    @staticmethod
    def backward(ctx, dmx, dbary_sel):
        packed, best, ids = ctx.saved_tensors
        sel_best = best[ids]
        winner = ((packed.to(torch.int64) & 0xFFFFFFFF) == sel_best) \
            & (sel_best != 0)
        zero = torch.zeros((), dtype=dmx.dtype, device=dmx.device)
        ddata = torch.where(winner, dmx[ids], zero).to(ctx.data_dtype)
        dbary = None
        if ctx.needs_input_grad[1]:
            dbary = torch.where(winner, dbary_sel[ids], zero).sum(-1)
        return ddata, dbary, None, None, None


def segment_max_with_bary_packed(data, bary, segment_ids, num_segments: int,
                                 valid):
    """Per-segment, per-channel max of bf16 ``data`` and the barycentric
    weight of the winning row, in one scatter: the packed values (uint32,
    held in int64) reduced by ``scatter_reduce("amax")`` into a zero fill;
    0 is the empty identity, so empty segments give (0, 0).  The gradient
    flows straight through to the winning rows (:class:`_SegmentMaxPacked`).

    Args:
      data: (R, C) rows, cast to bf16; bary: (R,) float32 in [0, 1];
      segment_ids: (R,) int64 in [0, num_segments); valid: (R,) bool,
        invalid rows never win.
    Returns (mx (S, C) float32, bary_sel (S, C) float32).
    """
    return _SegmentMaxPacked.apply(data, bary, segment_ids, num_segments,
                                   valid)


def segment_max_with_argmax(data, segment_ids, num_segments: int,
                            valid=None):
    """Per-segment, per-channel max and the winning row (the JAX package's
    ``segment_max_with_argmax``, torch_scatter's ``scatter_max``
    semantics): empty segments give 0 and -1, invalid rows never win, and
    among tied rows the largest row index wins.  Both reductions are one
    ``scatter_reduce("amax")`` each (max is exact in any order); the
    gradient of the max is shared among tied rows, as the JAX package's
    scatter max shares it.

    Args:
      data: (R, C) rows; segment_ids: (R,) int64 in [0, num_segments);
      valid: optional (R,) bool.
    Returns (max (S, C) in data's dtype, argmax (S, C) int64).
    """
    r, c = data.shape
    neg = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
    masked = data if valid is None else torch.where(valid[:, None], data, neg)
    idx = segment_ids[:, None].expand(r, c)
    mx = torch.full((num_segments, c), float("-inf"), dtype=data.dtype,
                    device=data.device).scatter_reduce(0, idx, masked, "amax")
    has = torch.isfinite(mx)
    mxz = torch.where(has, mx, torch.zeros((), dtype=data.dtype,
                                           device=data.device))
    winner = masked == mx.detach()[segment_ids]
    if valid is not None:
        winner &= valid[:, None]
    rows = torch.arange(r, device=data.device)[:, None]
    none = torch.full((), -1, dtype=torch.int64, device=data.device)
    arg = torch.full((num_segments, c), -1, dtype=torch.int64,
                     device=data.device).scatter_reduce(
        0, idx, torch.where(winner, rows, none), "amax")
    return mxz, torch.where(has, arg, none)


def segment_mean(data, segment_ids, num_segments: int, valid=None):
    """Per-segment mean of the (valid) rows of ``data``, 0 for an empty
    segment (the JAX package's ``segment_mean``, segment 0 included), on
    :func:`lattice_ops.segment_sum`: the same bits on every call.

    Args:
      data: (R, C); segment_ids: (R,) int64 in [0, num_segments);
      valid: optional (R,) bool.
    Returns (num_segments, C) in data's dtype."""
    w = (torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
         if valid is None else valid.to(data.dtype))
    sums = segment_sum(data * w[:, None], segment_ids, num_segments)
    cnts = segment_sum(w, segment_ids, num_segments)
    return sums / torch.clamp(cnts, min=1.0)[:, None]
