"""Packed value + barycentric-weight segment max over contiguous sorted
sub-runs (forward of the JAX package's ``ops/segment.sorted_packed_max``).

The bf16 value bits (monotone-mapped) go into the high 16 bits of a uint32
and the quantised barycentric weight into the low 16, so one segmented
running max (kernel K4) carries both; each bucket's result is read at its
tail row.  Max does not depend on order, so the tail maxima are bit-equal
to the JAX package's windowed two-level scan.
"""

from __future__ import annotations

import torch

from .seg_scan import sorted_segment_max_u32


def _pack_value_bary(data: torch.Tensor, bary: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """(Q, C) int64 holding uint32 values: monotone bf16 bits << 16 |
    round(bary * 65535); 0 for dead rows (the uint32 max identity)."""
    bits = data.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    mono = torch.where(bits >= 0x8000, bits ^ 0xFFFF, bits | 0x8000)
    b16 = (torch.clamp(bary, 0.0, 1.0) * 65535.0 + 0.5).to(torch.int64)
    packed = (mono << 16) | b16[:, None]
    return torch.where(live[:, None], packed, torch.zeros_like(packed))


def _decode_packed(best: torch.Tensor):
    """(B, C) int64 uint32 values -> (max (B, C) float32, bary (B, C))."""
    has = best != 0
    mono = best >> 16
    bits = torch.where(mono >= 0x8000, mono ^ 0x8000, mono ^ 0xFFFF)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    mx = bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)
    mx = torch.where(has, mx, torch.zeros_like(mx))
    bary_sel = torch.where(has, (best & 0xFFFF).to(torch.float32) / 65535.0,
                           torch.zeros_like(mx))
    return mx, bary_sel


def sorted_packed_max(data, bary, live, head_count, tailpos, bucket_live):
    """Packed value + bary segment max over contiguous sorted sub-runs.

    Args:
      data: (Q, C) rows in sorted order (cast to bf16 for packing).
      bary: (Q,) float32; live: (Q,) bool.
      head_count: (Q,) int32 sub-run ids (nondecreasing).
      tailpos: (B,) or (T, cap) int64 sorted position of each bucket tail.
      bucket_live: matching bool, False for empty buckets.
    Returns (mx (B, C) float32, bary_sel (B, C) float32).
    """
    packed = _pack_value_bary(data, bary, live)
    # uint32 bits as int32 (two's complement, spelled out)
    bits = torch.where(packed >= 1 << 31, packed - (1 << 32), packed) \
        .to(torch.int32).contiguous()
    scanned = sorted_segment_max_u32(head_count, bits)
    best = scanned[tailpos.reshape(-1)].to(torch.int64) & 0xFFFFFFFF
    best = torch.where(bucket_live.reshape(-1, 1), best, torch.zeros_like(best))
    return _decode_packed(best)
