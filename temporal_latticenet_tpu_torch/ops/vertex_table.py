"""Packed lattice keys and the static-capacity vertex table of the streaming
path (port of the JAX package's ``ops/vertex_table.py``).

A permutohedral vertex key has all full coordinates congruent to one
remainder r (mod 4), so its three stored coordinates pack losslessly into
32 bits: 10 bits per (coord - r)/4 + bias, plus 2 bits of r.  The JAX
package carries packed keys as uint32; torch on the CPU has no uint32
shifts, max or searchsorted, so the port carries them as **int64** holding
the same 32-bit value.  ``PACKED_SENTINEL`` (0xFFFFFFFF) still sorts last.

The table keeps the packed keys in stable (insertion) order, a sorted view
for batched binary-search lookups, and the unpacked coordinates.  Insertion
is append-only: indices never move and the vertex set only grows across the
frames of a sequence.  Stable slot 0 is the reserved "invalid" bucket: rows
whose insertion failed (capacity overflow or out-of-range keys) map to it.
Counts stay on the device, so no step reads them on the host.
"""

from __future__ import annotations

import dataclasses

import torch

SENTINEL = 2**31 - 1                  # unpacked padding coordinate (int32 max)
PACKED_SENTINEL = 0xFFFFFFFF

_DP1 = 4
_BIAS = 512
_MMAX = 1021  # (coord - r)/4 + _BIAS must stay in [0, _MMAX]
# composite sort key of the union: packed << 31 | payload.  Packed keys are
# below 2^32 and payloads below 2^31, so it fits in 63 bits (a shift by 32
# would overflow int64 for the sentinel)
_PAYLOAD_BITS = 31


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


@dataclasses.dataclass
class VertexTable:
    """Fixed-capacity set of lattice keys with stable indices."""

    keys: torch.Tensor              # (C, 3) int32 by stable index (SENTINEL rows unused)
    packed: torch.Tensor            # (C,) int64 packed keys by stable index
    sorted_packed: torch.Tensor     # (C,) int64 ascending (sentinels last)
    sorted_to_stable: torch.Tensor  # (C,) int64 sorted position -> stable index
    count: torch.Tensor             # () int64 used slots, slot 0 included

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def make_table(capacity: int, device=None) -> VertexTable:
    """Fresh empty table on ``device``; slot 0 pre-reserved."""
    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int64, device=device)
    return VertexTable(
        keys=torch.full((capacity, 3), SENTINEL, dtype=torch.int32,
                        device=device),
        packed=full((capacity,), PACKED_SENTINEL),
        sorted_packed=full((capacity,), PACKED_SENTINEL),
        sorted_to_stable=torch.arange(capacity, device=device),
        count=full((), 1))


def lookup_packed(table: VertexTable, q: torch.Tensor) -> torch.Tensor:
    """(Q,) packed queries -> (Q,) int64 stable indices or -1."""
    pos, (st,) = lookup_select(table.sorted_packed, q,
                               payloads=(table.sorted_to_stable,))
    return torch.where(pos >= 0, st, torch.full_like(st, -1))


def lookup(table: VertexTable, queries: torch.Tensor) -> torch.Tensor:
    """(Q, 3) integer query keys -> (Q,) stable indices or -1; sentinel and
    out-of-range queries give -1."""
    return lookup_packed(table, pack_keys(queries))


def scatter_or_drop(base: torch.Tensor, dst: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """``base.at[dst].set(src, mode="drop")`` for destinations in [0, len]
    where ``len(base)`` is the drop slot: a copy of ``base`` with one extra
    row takes the dropped writes (``index_put_`` raises on them)."""
    pad = torch.zeros((1,) + tuple(base.shape[1:]), dtype=base.dtype,
                      device=base.device)
    out = torch.cat([base, pad])
    out[dst] = src.to(base.dtype)
    return out[:-1]


def scatter_where(base: torch.Tensor, keep: torch.Tensor, dst: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``base[dst[keep]] = src[keep]`` on a copy of ``base``, without the
    host sync of a boolean index: the entries not kept write to the drop
    slot ``len(base)`` of :func:`scatter_or_drop` instead."""
    return scatter_or_drop(base, torch.where(keep, dst, base.shape[0]), src)


def shifted_ne(x: torch.Tensor) -> torch.Tensor:
    """[True, x[1:] != x[:-1]]."""
    out = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    out[1:] = x[1:] != x[:-1]
    return out


def union_and_index_packed(table: VertexTable, packed: torch.Tensor):
    """Insert packed candidate keys (append-only) and index every candidate.

    ``packed``: (Q,) int64, ``PACKED_SENTINEL`` for rows to ignore.  New
    unique keys are appended in ascending packed order; a candidate maps to
    its key's stable index, or to 0 when it is invalid or was dropped on
    overflow.  Bit for bit the JAX package's ``union_and_index``: one
    combined (C+Q) sort makes duplicates runs, and a run that holds a table
    entry has it first (its payload, a stable id < C, sorts before the
    candidates' payloads >= C).

    Returns ``(new_table, row_idx (Q,) int64)``."""
    qn = packed.shape[0]
    cap = table.capacity
    dev = packed.device

    payload = torch.cat([table.sorted_to_stable,
                         torch.arange(qn, device=dev) + cap])
    comp = torch.sort((torch.cat([table.sorted_packed, packed])
                       << _PAYLOAD_BITS) | payload).values
    sk = comp >> _PAYLOAD_BITS
    sp = comp & ((1 << _PAYLOAD_BITS) - 1)

    is_table = sp < cap
    is_cand = ~is_table
    valid = sk != PACKED_SENTINEL
    head = valid & shifted_ne(sk)
    # a candidate that heads its run has no equal table entry: a new key
    is_new = head & is_cand
    new_stable = table.count + torch.cumsum(is_new.to(torch.int64), 0) - 1
    ok = is_new & (new_stable < cap)
    new_stable = torch.where(ok, new_stable, torch.zeros_like(new_stable))

    # each run head's stable index, propagated to the whole run
    head_stable = torch.where(is_table, sp, new_stable)
    run_id = torch.cumsum(head.to(torch.int64), 0) - 1
    n = sk.shape[0]
    runs = scatter_or_drop(
        torch.zeros(n, dtype=torch.int64, device=dev),
        torch.where(head, run_id, torch.full_like(run_id, n)), head_stable)
    resolved = torch.where(valid, runs[run_id.clamp(min=0)],
                           torch.zeros_like(run_id))

    # candidate resolutions back in row order
    row_idx = scatter_or_drop(
        torch.zeros(qn, dtype=torch.int64, device=dev),
        torch.where(is_cand, sp - cap, torch.full_like(sp, qn)), resolved)

    # stable-order arrays: append the new unique keys
    scatter_at = torch.where(ok, new_stable, torch.full_like(new_stable, cap))
    new_keys = scatter_or_drop(table.keys, scatter_at, unpack_keys(sk))
    new_packed = scatter_or_drop(table.packed, scatter_at, sk)
    new_count = torch.clamp(table.count + ok.sum(), max=cap)

    # sorted view by compaction of the already-sorted combined array:
    # existing entries and new keys
    keep = (is_table & valid) | ok
    kpos = torch.cumsum(keep.to(torch.int64), 0) - 1
    dst = torch.where(keep & (kpos < cap), kpos, torch.full_like(kpos, cap))
    sorted_packed = scatter_or_drop(
        torch.full((cap,), PACKED_SENTINEL, dtype=torch.int64, device=dev),
        dst, sk)
    sorted_to_stable = scatter_or_drop(
        torch.zeros(cap, dtype=torch.int64, device=dev), dst, head_stable)
    return VertexTable(keys=new_keys, packed=new_packed,
                       sorted_packed=sorted_packed,
                       sorted_to_stable=sorted_to_stable,
                       count=new_count), row_idx


def union_and_index(table: VertexTable, cand_keys: torch.Tensor,
                    cand_valid: torch.Tensor):
    """(Q, 3) candidate keys and (Q,) validity -> ``(new_table, row_idx)``;
    see :func:`union_and_index_packed`."""
    keys = torch.where(cand_valid[:, None], cand_keys.to(torch.int64),
                       torch.full((), SENTINEL, dtype=torch.int64,
                                  device=cand_keys.device))
    return union_and_index_packed(table, pack_keys(keys))
