"""Whole-sequence lattice construction: one birth-tagged union per level
(port of the JAX package's ``ops/seq_lattice.py``).

Every vertex gets a ``birth`` frame; stable indices are sorted by
(birth, packed key), so the vertex set of frame t is the prefix
[0, counts[t]) -- the append-only growth of the reference's un-reset
hashmap.  Neighbor tables and coarse-level links are built once against the
final vertex set; frame-t validity is ``birth <= t``.

``lax.sort(..., num_keys=k)`` becomes a stable ``torch.sort`` of one
composite int64 key (packed keys are < 2^32, births small), and the sorted
operands are gathered by the resulting permutation.  Sorts that return to
original row order become a scatter by the (unique) carried row id.  The
segmented scans run through kernels K2 and K3 (``seg_scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import permutohedral as pm
from .fused_simplex import fused_simplex_pack
from .lattice_ops import (DistributeOut, LevelLink, NeighborTable,
                          augment_link_sorted)
from .seg_scan import seg_sum_tails, sorted_segment_scan
from .vertex_table import (PACKED_SENTINEL, SENTINEL, shifted_ne,
                           lookup_select, pack_keys, unpack_keys)


@dataclasses.dataclass
class SeqLevel:
    """One lattice level, finalised for the whole sequence."""

    keys: torch.Tensor       # (C, 3) int32, birth-then-packed order; row 0 reserved
    birth: torch.Tensor      # (C,) int64 frame of first appearance (T if unused)
    counts: torch.Tensor     # (T,) int64 occupied slots (incl. slot 0) at frame t
    nbr_idx: torch.Tensor    # (C', 9) int64 one-hop neighbors in the final set
    nbr_found: torch.Tensor  # (C', 9) bool
    nbr_birth: torch.Tensor  # (C', 9) int64 neighbor birth (T where absent)


@dataclasses.dataclass
class SortedPN:
    """Union-sorted pointnet inputs: every (vertex, frame) bucket is a
    contiguous sub-run of the sorted rows."""

    rel: torch.Tensor        # (Q, 3) float32 rel-to-local-mean positions, sorted
    so: torch.Tensor         # (Q,) int64 original row id per sorted row
    live: torch.Tensor       # (Q,) bool row lands in a real vertex slot
    head_vf: torch.Tensor    # (Q,) bool (vertex, frame) sub-run heads
    bucket: torch.Tensor     # (Q,) int64 frame*cap + vertex slot (T*cap if dead)
    tailpos: torch.Tensor    # (T, cap) int64 sorted position of bucket tails
    vals: torch.Tensor | None = None        # (Q, v) bf16, sorted, unmasked
    bary: torch.Tensor | None = None        # (Q,) float32 on the 1/65535 grid
    head_count: torch.Tensor | None = None  # (Q,) int32 sub-run ids


@dataclasses.dataclass
class SeqLattice:
    """All levels plus the level-0 splat rows of every frame."""

    levels: Tuple[SeqLevel, ...]
    links: Tuple[LevelLink, ...]
    row_vertex: torch.Tensor       # (T, P*4) int64
    row_bary: torch.Tensor         # (T, P*4) float32
    row_valid: torch.Tensor        # (T, P*4) bool
    row_rel_pos: torch.Tensor      # (T, P*4, 3) float32
    point_vertex: torch.Tensor     # (T, P, 4) int64
    point_bary: torch.Tensor       # (T, P, 4) float32
    nr_points: torch.Tensor | None = None   # (T, C0) float32 rows per vertex
    sorted_pn: SortedPN | None = None

    def distribute_out(self) -> DistributeOut:
        """Every frame's splat rows and points as one (T, ...)
        ``DistributeOut``; ``.frame(t)`` is frame t's."""
        return DistributeOut(
            row_vertex=self.row_vertex, row_bary=self.row_bary,
            row_rel_pos=self.row_rel_pos, row_valid=self.row_valid,
            point_vertex=self.point_vertex, point_bary=self.point_bary)

    def frame_nbr(self, level: int, t: int) -> NeighborTable:
        """Neighbor table as visible at frame t (unborn neighbors absent)."""
        lv = self.levels[level]
        return NeighborTable(idx=lv.nbr_idx,
                             found=lv.nbr_found & (lv.nbr_birth <= t))


def _sort_perm(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of an int64 key."""
    return torch.sort(key, stable=True).indices


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a (Q,) int32 vector: one K2 ``sum`` scan over a
    single run (no run ids)."""
    return sorted_segment_scan(None, x.to(torch.int32)[:, None].contiguous(),
                               "sum")[:, 0]


def _seg_copy_head(head: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Each run head's value propagated across its run (K2 ``first``)."""
    ids = _blocked_cumsum(head.to(torch.int32))
    return sorted_segment_scan(ids, val.to(torch.int32)[:, None].contiguous(),
                               "first")[:, 0]


def _seg_sum_rows(head: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive row sum, resetting where ``head`` (K2 ``sum``)."""
    ids = _blocked_cumsum(head.to(torch.int32))
    return sorted_segment_scan(ids, val.contiguous(), "sum")


def _head_table(head2, fits, urank2, k2, b2, capacity: int, n_frames: int):
    """Capacity-sized (packed, birth) tables from the run heads of the
    (birth, key)-sorted candidates; slot 0 is the reserved invalid bucket."""
    dev = k2.device
    hkey = torch.where(head2 & fits, urank2.to(torch.int64),
                       torch.full_like(k2, 0xFFFFFFFF))
    order = _sort_perm(hkey)
    kk, bb = k2[order], b2[order]
    if kk.shape[0] < capacity - 1:
        pad = capacity - 1 - kk.shape[0]
        kk = torch.cat([kk, torch.full((pad,), PACKED_SENTINEL,
                                       dtype=kk.dtype, device=dev)])
        bb = torch.cat([bb, torch.full((pad,), n_frames, dtype=bb.dtype,
                                       device=dev)])
    n_heads = torch.clamp(urank2[-1].to(torch.int64) + 1, max=capacity - 1)
    live = torch.arange(capacity - 1, device=dev) < n_heads
    packed_final = torch.cat([
        torch.full((1,), PACKED_SENTINEL, dtype=torch.int64, device=dev),
        torch.where(live, kk[: capacity - 1],
                    torch.full_like(kk[: capacity - 1], PACKED_SENTINEL))])
    birth_final = torch.cat([
        torch.full((1,), n_frames, dtype=torch.int64, device=dev),
        torch.where(live, bb[: capacity - 1].to(torch.int64),
                    torch.full((capacity - 1,), n_frames, dtype=torch.int64,
                               device=dev))])
    return packed_final, birth_final


def _frame_counts(packed_final, birth_final, n_frames: int) -> torch.Tensor:
    t = torch.arange(n_frames, device=packed_final.device)
    alive = (birth_final[None, :] <= t[:, None]) \
        & (packed_final != PACKED_SENTINEL)[None, :]
    return 1 + alive.sum(dim=1)


def _pack_pn_rows(vals_rows: torch.Tensor, bary_rows: torch.Tensor):
    """Point values (as bf16 bits) and the barycentric weight (quantised to
    1/65535) packed two 16-bit units per column, hi first: (Q, ceil((v+1)/2))
    int64 columns holding uint32 values."""
    q, v = vals_rows.shape
    units = [vals_rows[:, i].to(torch.bfloat16).view(torch.int16)
             .to(torch.int64) & 0xFFFF for i in range(v)]
    units.append((torch.clamp(bary_rows, 0.0, 1.0) * 65535.0 + 0.5)
                 .to(torch.int64))
    if len(units) % 2:
        units.append(torch.zeros(q, dtype=torch.int64,
                                 device=vals_rows.device))
    cols = [(units[2 * j] << 16) | (units[2 * j + 1] & 0xFFFF)
            for j in range(len(units) // 2)]
    return torch.stack(cols, dim=1)


def _u16_to_bf16(u: torch.Tensor) -> torch.Tensor:
    s = torch.where(u >= 0x8000, u - 0x10000, u)
    return s.to(torch.int16).view(torch.bfloat16)


def _unpack_pn_rows(cols: torch.Tensor, n_vals: int):
    """Inverse of :func:`_pack_pn_rows` on sorted columns: ((Q, v) bf16
    values, (Q,) float32 bary on the 1/65535 grid)."""
    units = []
    for j in range(cols.shape[1]):
        units.append((cols[:, j] >> 16) & 0xFFFF)
        units.append(cols[:, j] & 0xFFFF)
    vals = torch.stack([_u16_to_bf16(units[i]) for i in range(n_vals)], dim=1)
    bary = units[n_vals].to(torch.float32) / 65535.0
    return vals, bary


def _union_with_birth_and_mean(cand_packed, pos_rows, capacity: int,
                               n_frames: int, extra_rows=None, n_vals: int = 0,
                               skip_rel_unsort: bool = False):
    """Level-0 union that also computes each row's position relative to its
    per-(vertex, frame) mean inside the union's sorted order.

    Returns (packed_final (C,), birth (C,), row_idx (Q,), counts (T,),
    rel (Q, 3) original order, nr_points (T, C), sorted_pn)."""
    dev = cand_packed.device
    q = cand_packed.shape[0]
    per_frame = q // n_frames

    so = _sort_perm(cand_packed)
    sp = cand_packed[so]
    pos_s = pos_rows[so]
    ex1 = None if extra_rows is None else extra_rows[so]
    birth_rows = so // per_frame

    valid = sp != PACKED_SENTINEL
    head = valid & shifted_ne(sp)
    tfill = torch.full_like(birth_rows, n_frames)
    birth = _seg_copy_head(head, torch.where(valid, birth_rows, tfill))
    birth = torch.where(valid, birth.to(torch.int64), tfill)

    order2 = _sort_perm((birth << 32) | sp)
    b2, k2, so2 = birth[order2], sp[order2], so[order2]
    pos2 = pos_s[order2]
    ex2 = None if ex1 is None else ex1[order2]

    valid2 = k2 != PACKED_SENTINEL
    head2 = valid2 & shifted_ne(k2)
    urank2 = _blocked_cumsum(head2.to(torch.int32)).to(torch.int64) - 1
    fits = valid2 & (urank2 < capacity - 1)
    fin = torch.where(fits, urank2 + 1, torch.zeros_like(urank2))

    # per-(vertex, frame) sub-runs: rows of a key run are frame-ordered
    frame2 = so2 // per_frame
    head_vf = head2 | shifted_ne(frame2)
    tail_vf = torch.ones_like(head_vf)
    tail_vf[:-1] = head_vf[1:]
    w2 = fits.to(torch.float32)
    data = torch.cat([pos2 * w2[:, None], w2[:, None]], dim=1)
    m = n_frames * capacity
    bucket = torch.where(fits, frame2 * capacity + fin,
                         torch.full_like(fin, m))

    # tail compaction: the first m stably-sorted keys are the bucket tails
    tkey = torch.where(tail_vf & fits, bucket, torch.full_like(bucket,
                                                               0xFFFFFFFF))
    spos = _sort_perm(tkey)
    sk = tkey[spos]
    if q < m:
        pad = m - q
        sk = torch.cat([sk, torch.full((pad,), 0xFFFFFFFF, dtype=sk.dtype,
                                       device=dev)])
        spos = torch.cat([spos, torch.zeros(pad, dtype=spos.dtype,
                                            device=dev)])
    sk, tails_i = sk[:m], spos[:m]
    real = sk != 0xFFFFFFFF
    ids_vf = _blocked_cumsum(head_vf.to(torch.int32))
    tail_sums = seg_sum_tails(ids_vf, data, tails_i.contiguous())
    # table of per-bucket (sums, tail position); row m collects dead rows
    buf = torch.zeros((m + 1, 5), dtype=torch.float32, device=dev)
    buf[sk[real]] = torch.cat([tail_sums, tails_i[:, None].to(torch.float32)],
                              dim=1)[real]
    tot = buf[bucket][:, :4]
    nr_points = buf[:m, 3].reshape(n_frames, capacity).clone()
    tailpos = buf[:m, 4].to(torch.int64).reshape(n_frames, capacity)
    mean2 = tot[:, :3] / torch.clamp(tot[:, 3:], min=1.0)
    rel2 = (pos2 - mean2) * w2[:, None]
    nr_points[:, 0] = 0.0

    # back to original row order: a scatter by the unique row id
    row_idx = torch.empty_like(fin)
    row_idx[so2] = fin
    rel = torch.zeros((q, 3), dtype=torch.float32, device=dev)
    if not skip_rel_unsort:
        rel[so2] = rel2

    # head table from the mean tables: a slot's birth is the first frame
    # with points, and tailpos[birth, s] is a sorted row holding its key
    nz = nr_points > 0.0
    any_slot = nz.any(dim=0)
    bf = torch.argmax(nz.to(torch.int32), dim=0)
    rep = tailpos[bf, torch.arange(capacity, device=dev)]
    packed_final = torch.where(any_slot, k2[rep],
                               torch.full_like(k2[rep], PACKED_SENTINEL))
    birth_final = torch.where(any_slot, bf, torch.full_like(bf, n_frames))
    counts = _frame_counts(packed_final, birth_final, n_frames)

    pn_vals = pn_bary = None
    if ex2 is not None:
        pn_vals, pn_bary = _unpack_pn_rows(ex2, n_vals)
    sorted_pn = SortedPN(rel=rel2, so=so2, live=fits, head_vf=head_vf,
                         bucket=bucket, tailpos=tailpos, vals=pn_vals,
                         bary=pn_bary, head_count=ids_vf)
    return (packed_final, birth_final, row_idx, counts, rel, nr_points,
            sorted_pn)


def _finish_union(sp, so, birth_rows, capacity: int, n_frames: int):
    """Shared tail of the no-mean unions; ``sp``/``so``/``birth_rows`` are
    the stable key-sorted candidates."""
    valid = sp != PACKED_SENTINEL
    head = valid & shifted_ne(sp)
    tfill = torch.full_like(birth_rows, n_frames)
    birth = _seg_copy_head(head, torch.where(valid, birth_rows, tfill))
    birth = torch.where(valid, birth.to(torch.int64), tfill)

    # final order (birth, key); overflow drops youngest-then-largest
    order2 = _sort_perm((birth << 32) | sp)
    b2, k2, so2 = birth[order2], sp[order2], so[order2]
    valid2 = k2 != PACKED_SENTINEL
    head2 = valid2 & shifted_ne(k2)
    urank2 = _blocked_cumsum(head2.to(torch.int32)).to(torch.int64) - 1
    fits = valid2 & (urank2 < capacity - 1)
    fin = torch.where(fits, urank2 + 1, torch.zeros_like(urank2))

    row_idx = torch.empty_like(fin)
    row_idx[so2] = fin
    packed_final, birth_final = _head_table(head2, fits, urank2, k2, b2,
                                            capacity, n_frames)
    counts = _frame_counts(packed_final, birth_final, n_frames)
    return packed_final, birth_final, row_idx, counts


def _union_with_birth(cand_packed, cand_order, capacity: int, n_frames: int):
    """Birth-ordered stable indices for unique candidate keys; birth is
    ``cand_order // per_frame`` of each key run's earliest row."""
    per_frame = cand_packed.shape[0] // n_frames
    order = _sort_perm(cand_packed)
    so = cand_order[order]
    return _finish_union(cand_packed[order], so, so // per_frame, capacity,
                         n_frames)


def _union_with_birth_explicit(cand_packed, cand_birth, capacity: int,
                               n_frames: int):
    """Like :func:`_union_with_birth` with an explicit per-candidate birth
    (coarse levels inherit the fine vertices' births)."""
    so = _sort_perm(cand_packed)
    return _finish_union(cand_packed[so], so, cand_birth[so], capacity,
                         n_frames)


def _build_level(packed_final, birth_final, counts, n_frames: int,
                 nbr_rows: int | None = None):
    """Neighbor structure for a finalised level, restricted to the
    [0, nbr_rows) row prefix.  Only the positive offsets are looked up; the
    negative half is their inverse (if B = A + o_a then A = B - o_a)."""
    dev = packed_final.device
    cap = packed_final.shape[0]
    keys = unpack_keys(packed_final)
    nr = cap if nbr_rows is None else min(nbr_rows, cap)

    offs = pm.neighbor_offsets_tensor(3, dev)
    n_half = offs.shape[0] // 2
    queries = (keys[:nr, None, :].to(torch.int64)
               + offs[None, :n_half, :]).reshape(nr * n_half, 3)
    qpacked = pack_keys(queries)
    order = _sort_perm(packed_final)
    s_packed = packed_final[order]
    pos, (st, bi) = lookup_select(s_packed, qpacked,
                                  payloads=(order, birth_final[order]))
    pos = pos.reshape(nr, n_half)
    valid_self = packed_final[:nr] != PACKED_SENTINEL
    fwd_found = (pos >= 0) & valid_self[:, None]
    fwd_idx = torch.where(fwd_found, st.reshape(nr, n_half),
                          torch.full_like(pos, -1))
    fwd_birth = bi.reshape(nr, n_half)

    # reverse edges: nbr[B, n_half + a] = A wherever nbr[A, a] = B; A's index
    # and birth packed into one value, at most one writer per slot
    stable = torch.arange(cap, device=dev)
    a_idx = torch.arange(n_half, device=dev)[None, :].expand(nr, n_half)
    hitm = fwd_found & (fwd_idx < nr)
    src = (stable[:nr, None] | (birth_final[:nr, None] << 24)).expand(
        nr, n_half)
    buf = torch.full((nr * n_half,), -1, dtype=torch.int64, device=dev)
    buf[(fwd_idx * n_half + a_idx)[hitm]] = src[hitm]
    rev = buf.reshape(nr, n_half)
    rev_found = (rev >= 0) & valid_self[:, None]
    rev_idx = torch.where(rev_found, rev & 0xFFFFFF, torch.full_like(rev, -1))
    rev_birth = rev >> 24

    self_idx = torch.arange(nr, device=dev)
    idx = torch.cat([fwd_idx.clamp(min=0), rev_idx.clamp(min=0),
                     self_idx[:, None]], dim=1)
    found = torch.cat([fwd_found, rev_found, valid_self[:, None]], dim=1)
    all_birth = torch.cat([fwd_birth, rev_birth, birth_final[:nr, None]],
                          dim=1)
    nbr_birth = torch.where(found, all_birth,
                            torch.full_like(all_birth, n_frames))
    return SeqLevel(keys=keys, birth=birth_final, counts=counts, nbr_idx=idx,
                    nbr_found=found, nbr_birth=nbr_birth)


def build_sequence_lattice(positions: torch.Tensor, mask: torch.Tensor,
                           sigma: float, capacities, nr_downsamples: int,
                           nbr_caps=None,
                           pn_values: torch.Tensor | None = None,
                           want_row_rel: bool = True) -> SeqLattice:
    """Args:
      positions: (T, P, 3) float32 padded frames.
      mask: (T, P) bool.
      capacities: per-level static table sizes.
      nbr_caps: optional per-level neighbor-table row prefixes.
      pn_values: optional (T, P, v) float32 point values that ride the
        union's sorts for the batched pointnet.
      want_row_rel: False when nothing reads ``row_rel_pos`` (it is then
        zeros).
    """
    t_frames, p, _ = positions.shape
    dp1 = 4
    cap0 = capacities[0]

    rvalid = mask.repeat_interleave(dp1, dim=1)                  # (T, P*4)
    y = pm.scale_positions(positions.reshape(t_frames * p, 3), sigma)
    packed4, bary4 = fused_simplex_pack(y.contiguous(),
                                        mask.reshape(-1).contiguous())
    cand_packed = packed4.reshape(-1)
    bary = bary4.reshape(t_frames, p * dp1)
    pos_rows = positions.repeat_interleave(dp1, dim=1)           # (T, P*4, 3)

    extra_rows, n_vals = None, 0
    if pn_values is not None:
        n_vals = pn_values.shape[-1]
        vals_rows = pn_values.reshape(t_frames * p, n_vals) \
            .repeat_interleave(dp1, dim=0)
        extra_rows = _pack_pn_rows(vals_rows, bary.reshape(-1))
    (packed0, birth0, row_idx, counts0, rel_flat, nr_points,
     sorted_pn) = _union_with_birth_and_mean(
        cand_packed, pos_rows.reshape(-1, 3), cap0, t_frames,
        extra_rows=extra_rows, n_vals=n_vals,
        skip_rel_unsort=not want_row_rel)
    rel = rel_flat.reshape(t_frames, p * dp1, 3)
    row_vertex = row_idx.reshape(t_frames, p * dp1)
    row_valid = rvalid & (row_vertex > 0)
    row_bary = torch.where(row_valid, bary, torch.zeros_like(bary))

    levels, links = [], []
    levels.append(_build_level(packed0, birth0, counts0, t_frames,
                               None if nbr_caps is None else nbr_caps[0]))
    packed_f, birth_f = packed0, birth0
    for l in range(nr_downsamples):
        cap_f, cap_c = capacities[l], capacities[l + 1]
        valid_f = packed_f != PACKED_SENTINEL
        # sentinel rows are zeroed first: their corners are masked anyway,
        # and the float->int conversion of 2^31-sized keys is undefined
        keys_f = torch.where(valid_f[:, None], unpack_keys(packed_f),
                             torch.zeros((), dtype=torch.int32,
                                         device=packed_f.device)
                             ).to(torch.float32)
        full = torch.cat([keys_f, -keys_f.sum(-1, keepdim=True)], dim=-1)
        ckeys, cbary = pm.find_enclosing_simplex(full * 0.5)   # (Cf, 4, 3)
        flat_c = torch.where(valid_f.repeat_interleave(dp1)[:, None],
                             ckeys.reshape(-1, 3),
                             torch.full((), SENTINEL, dtype=torch.int32,
                                        device=ckeys.device))
        packed_c, birth_c, c_row_idx, counts_c = _union_with_birth_explicit(
            pack_keys(flat_c), birth_f.repeat_interleave(dp1), cap_c,
            t_frames)
        corner_idx = c_row_idx.reshape(cap_f, dp1)
        corner_bary = torch.where(valid_f[:, None] & (corner_idx > 0), cbary,
                                  torch.zeros_like(cbary))
        links.append(augment_link_sorted(corner_idx, corner_bary, cap_c))
        levels.append(_build_level(
            packed_c, birth_c, counts_c, t_frames,
            None if nbr_caps is None else nbr_caps[l + 1]))
        packed_f, birth_f = packed_c, birth_c

    return SeqLattice(
        levels=tuple(levels), links=tuple(links), row_vertex=row_vertex,
        row_bary=row_bary, row_valid=row_valid, row_rel_pos=rel,
        point_vertex=row_vertex.reshape(t_frames, p, dp1),
        point_bary=row_bary.reshape(t_frames, p, dp1),
        nr_points=nr_points, sorted_pn=sorted_pn)


def trim_sequence_lattice(lat: SeqLattice, trim_caps) -> SeqLattice:
    """Truncate a finalised SeqLattice to the row prefixes ``trim_caps``.
    Indices pointing past a cap belong to vertices unborn in the frames the
    trimmed view serves; they are remapped to the zero row 0."""
    levels = []
    for l, lvl in enumerate(lat.levels):
        c = trim_caps[l]
        idx = lvl.nbr_idx[:c]
        levels.append(SeqLevel(
            keys=lvl.keys[:c], birth=lvl.birth[:c], counts=lvl.counts,
            nbr_idx=torch.where(idx < c, idx, torch.zeros_like(idx)),
            nbr_found=lvl.nbr_found[:c], nbr_birth=lvl.nbr_birth[:c]))
    links = []
    for l, link in enumerate(lat.links):
        cf, cc = trim_caps[l], trim_caps[l + 1]
        ci = link.corner_idx[:cf]
        ok = ci < cc
        links.append(augment_link_sorted(
            torch.where(ok, ci, torch.zeros_like(ci)),
            torch.where(ok, link.corner_bary[:cf],
                        torch.zeros_like(link.corner_bary[:cf])),
            cc))
    return dataclasses.replace(
        lat, levels=tuple(levels), links=tuple(links),
        nr_points=(None if lat.nr_points is None
                   else lat.nr_points[:, :trim_caps[0]]),
        sorted_pn=None)
