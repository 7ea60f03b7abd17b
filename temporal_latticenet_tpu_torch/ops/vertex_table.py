"""Packed lattice keys.

A permutohedral vertex key has all full coordinates congruent to one
remainder r (mod 4), so its three stored coordinates pack losslessly into
32 bits: 10 bits per (coord - r)/4 + bias, plus 2 bits of r.  The JAX
package carries packed keys as uint32; torch on the CPU has no uint32
shifts, max or searchsorted, so the port carries them as **int64** holding
the same 32-bit value.  ``PACKED_SENTINEL`` (0xFFFFFFFF) still sorts last.
"""

from __future__ import annotations

import torch

SENTINEL = 2**31 - 1                  # unpacked padding coordinate (int32 max)
PACKED_SENTINEL = 0xFFFFFFFF

_DP1 = 4
_BIAS = 512
_MMAX = 1021  # (coord - r)/4 + _BIAS must stay in [0, _MMAX]


def pack_keys(keys: torch.Tensor) -> torch.Tensor:
    """(Q, 3) integer lattice keys -> (Q,) int64 packed keys;
    ``PACKED_SENTINEL`` when a coordinate is out of range or the row is the
    ``SENTINEL`` pad.  Arithmetic runs in int64, so sentinel rows plus a
    neighbor offset cannot wrap."""
    k = keys.to(torch.int64)
    r = k[:, 0] & 3                               # floor-mod 4
    m = ((k - r[:, None]) >> 2) + _BIAS           # exact multiples: >>2 == //4
    in_range = ((m >= 0) & (m <= _MMAX)).all(dim=-1)
    in_range &= k[:, 0] != SENTINEL
    packed = (m[:, 0] << 22) | (m[:, 1] << 12) | (m[:, 2] << 2) | r
    return torch.where(in_range, packed,
                       torch.full_like(packed, PACKED_SENTINEL))


def unpack_keys(packed: torch.Tensor) -> torch.Tensor:
    """(Q,) int64 packed keys -> (Q, 3) int32 keys (SENTINEL rows for
    ``PACKED_SENTINEL``)."""
    r = packed & 0x3
    m0 = ((packed >> 22) & 0x3FF) - _BIAS
    m1 = ((packed >> 12) & 0x3FF) - _BIAS
    m2 = ((packed >> 2) & 0x3FF) - _BIAS
    keys = torch.stack([m0, m1, m2], dim=-1) * _DP1 + r[:, None]
    keys = torch.where((packed == PACKED_SENTINEL)[:, None],
                       torch.full_like(keys, SENTINEL), keys)
    return keys.to(torch.int32)
