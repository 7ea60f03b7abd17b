"""Frozen copy of the port's ``ops/vertex_table.py`` (plain PyTorch only: no CUDA
kernel, no import of the port).  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.

Packed lattice keys (port of the JAX package's ``ops/vertex_table.py``),
cut to what the sequence lattice's build uses.

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


def lookup_select(sorted_packed: torch.Tensor, q: torch.Tensor, payloads=()):
    """(Q,) packed queries -> (position in ``sorted_packed`` or -1, payloads
    at the hit or 0): the contract of the JAX package's MXU one-hot lookup,
    as a binary search."""
    n = sorted_packed.shape[0]
    pos = torch.searchsorted(sorted_packed, q)
    pc = pos.clamp(max=n - 1)
    hit = (pos < n) & (sorted_packed[pc] == q) & (q != PACKED_SENTINEL)
    out = torch.where(hit, pc, torch.full_like(pc, -1))
    vals = tuple(torch.where(hit, p[pc], torch.zeros_like(p[pc]))
                 for p in payloads)
    return out, vals


def shifted_ne(x: torch.Tensor) -> torch.Tensor:
    """[True, x[1:] != x[:-1]]."""
    out = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    out[1:] = x[1:] != x[:-1]
    return out


