"""Kernels K2-K5: segmented scans over contiguous runs of sorted rows.

Runs are given by nondecreasing run ids (``head_count``): rows with equal
ids form one run.  Each public function launches its CUDA kernel for CUDA
tensors and uses its plain PyTorch version (the ``*_plain`` function beside
it) for CPU tensors; there is no other path.

* K2 :func:`sorted_segment_scan` (``csrc/seg_scan.cu``) replaces the Pallas
  kernel ``ops/pallas_scan.py:_seg_scan_kernel_lanes`` (wrapper
  ``sorted_segment_scan``): inclusive segmented ``sum`` (float32 or int32),
  ``max`` (int32) or ``first`` (the run head's value copied forward);
  ``sum`` with ``head_count=None`` is a cumsum over every row.  A single
  pass with decoupled look-back: a memset of the tile state and one kernel
  per call.
* K3 :func:`seg_sum_tails` (``csrc/seg_sum_tails.cu``) replaces
  ``_seg_scan_kernel_laneonly`` as composed by ``seg_sum_tails``: exact
  per-run totals at the given tail rows (K2's float32 sum, writing only the
  rows that end a run, then a gather of the tails).
* K4 :func:`sorted_segment_max_u32` (``csrc/seg_max.cu``) replaces
  ``_seg_max_kernel`` (wrappers ``sorted_segment_max_i32``/``_u32``): the
  inclusive segmented running max of uint32 bits held in int32, on K2's
  single-pass scan (a memset and one kernel per call).  The TPU kernel's
  ``max_window`` is a VMEM workaround; the port always computes the full
  window (callers read the tails, which are bit-equal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda

INT_MIN = -0x80000000
# K2's, K3's and K4's single-pass scan (seg_scan_lookback.cuh: kThreads,
# kStrip)
_LB_THREADS = 256
_LB_STRIP = 16
# the largest window K5 takes: its shared-memory halo is 2 * window - 1 rows
MAX_WINDOW = 16

# K2's modes (seg_scan.cuh: Mode)
_MODES = {"sum_f32": 0, "sum_i32": 1, "max_i32": 2, "first": 3}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _head_positions(head_count: torch.Tensor) -> torch.Tensor:
    """(Q,) int64 position of each row's run head."""
    q = head_count.shape[0]
    new = torch.ones(q, dtype=torch.bool, device=head_count.device)
    new[1:] = head_count[1:] != head_count[:-1]
    pos = torch.arange(q, device=head_count.device)
    return torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                        dim=0).values


def _run_sums_at(head_count, x, rows):
    """Exact-as-possible run sums from the run head to ``rows``: a float64
    (int64 for integers) prefix sum differenced at the run heads."""
    acc_t = torch.float64 if x.dtype.is_floating_point else torch.int64
    acc = torch.cumsum(x.to(acc_t), dim=0)
    hp = _head_positions(head_count)[rows]
    base = acc[(hp - 1).clamp(min=0)]
    base = torch.where((hp > 0)[:, None], base, torch.zeros_like(base))
    return (acc[rows] - base).to(x.dtype)


def _max_scan(head_count, x):
    """Hillis-Steele inclusive segmented max (log2(Q) passes)."""
    out = x
    q = x.shape[0]
    s = 1
    while s < q:
        same = (head_count[s:] == head_count[:-s])[:, None]
        upd = torch.where(same, torch.maximum(out[s:], out[:-s]), out[s:])
        out = torch.cat([out[:s], upd], dim=0)
        s *= 2
    return out


def sorted_segment_scan_plain(head_count, x, mode):
    if head_count is None and mode == "sum":      # one run: a cumsum
        acc_t = torch.float64 if x.dtype.is_floating_point else torch.int64
        return torch.cumsum(x.to(acc_t), dim=0).to(x.dtype)
    if mode == "first":
        return x[_head_positions(head_count)]
    if mode == "sum":
        rows = torch.arange(x.shape[0], device=x.device)
        return _run_sums_at(head_count, x, rows)
    if mode == "max":
        return _max_scan(head_count, x)
    raise ValueError(mode)


def seg_sum_tails_plain(head_count, x, tails):
    q = x.shape[0]
    ok = (tails >= 0) & (tails < q)
    t = tails.clamp(0, max(q - 1, 0))
    out = _run_sums_at(head_count, x, t)
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def sorted_segment_max_u32_plain(head_count, x):
    """uint32 order via the sign flip: x ^ 0x80000000 orders as int32."""
    flip = torch.tensor(INT_MIN, dtype=torch.int32, device=x.device)
    return _max_scan(head_count, x ^ flip) ^ flip


def sorted_segment_max_window_plain(head_count, x, window=None):
    """Row r: the uint32 max over rows [max(head(r), r - 2 window + 1), r],
    one shifted compare per row of the window; ``None`` is the full run."""
    if window is None:
        return sorted_segment_max_u32_plain(head_count, x)
    flip = torch.tensor(INT_MIN, dtype=torch.int32, device=x.device)
    xs = x ^ flip
    out = xs.clone()
    for j in range(1, min(2 * window, x.shape[0])):
        same = (head_count[j:] == head_count[:-j])[:, None]
        out[j:] = torch.where(same, torch.maximum(out[j:], xs[:-j]), out[j:])
    return out ^ flip


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check(head_count, x, dtypes, what, one_run_ok=False):
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (Q, C), got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous")
    if head_count is None and one_run_ok:
        return
    if head_count is None or head_count.shape != (x.shape[0],) \
            or head_count.dtype != torch.int32:
        raise ValueError(f"{what}: head_count must be (Q,) int32")
    if head_count.device != x.device:
        raise ValueError(f"{what}: tensors on different devices")
    if x.is_cuda and not head_count.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous")


class _Plan(NamedTuple):
    """Tiles of the single-pass scan (``csrc/seg_scan_lookback.cuh``)."""
    vw: int        # channels per vector: 4 (16-byte loads) or 1
    w: int         # threads that cover one row's vectors
    ncb: int       # channel blocks (grid y), each a scan of its own
    rows: int      # rows per tile
    ntiles: int    # tiles per channel block (grid x)

    @property
    def state_words(self) -> int:
        """int64 words of the tile state (``state_bytes`` in the header;
        cleared by each call): the int32 tile counters, then a 64-bit word
        per tile (C = 1) or an int32 status per (channel block, tile)."""
        return (self.ncb + 1) // 2 + self.ncb * self.ntiles


def _lookback_plan(q: int, c: int, vec: bool) -> _Plan:
    """``vec``: C % 4 == 0 and x 16-byte aligned."""
    vw = 4 if vec else 1
    lanes = -(-c // vw)
    w = min(1 << (lanes - 1).bit_length(), _LB_THREADS)
    rows = (_LB_THREADS // w) * _LB_STRIP
    return _Plan(vw, w, -(-lanes // w), rows, -(-q // rows))


def _lookback_scratch(plan: _Plan, x: torch.Tensor):
    """The tile state and the (2, ntiles, C) descriptor values (aggregates,
    inclusive prefixes), uninitialised: the launcher clears the state."""
    state = torch.empty(plan.state_words, dtype=torch.int64, device=x.device)
    desc = torch.empty((2, plan.ntiles, x.shape[1]), dtype=x.dtype,
                       device=x.device)
    return state, desc


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def sorted_segment_scan(head_count, x: torch.Tensor,
                        mode: str) -> torch.Tensor:
    """K2: inclusive segmented scan over contiguous runs.

    Args:
      head_count: (Q,) int32 nondecreasing run ids; for ``sum`` also None,
        one run over every row (no ids are read).
      x: (Q, C); float32 or int32 for ``sum``, int32 for ``max``, any 32-bit
        type for ``first``.
    Returns (Q, C) of x's dtype.  On the card, float32 sums are bit-equal
    from call to call.
    """
    if mode == "sum":
        dtypes = (torch.float32, torch.int32)
    elif mode == "max":
        dtypes = (torch.int32,)
    elif mode == "first":
        dtypes = (torch.float32, torch.int32)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    _check(head_count, x, dtypes, "sorted_segment_scan",
           one_run_ok=mode == "sum")
    if x.device.type == "cpu":
        return sorted_segment_scan_plain(head_count, x, mode)
    code = _MODES["first"] if mode == "first" else _MODES[
        f"{mode}_{'f32' if x.dtype == torch.float32 else 'i32'}"]
    q, c = x.shape
    out = torch.empty_like(x)
    if q == 0 or c == 0:
        return out
    plan = _lookback_plan(q, c, c % 4 == 0 and x.data_ptr() % 16 == 0)
    state, desc = _lookback_scratch(plan, x)
    fn = _cuda.function("seg_scan", "tln_seg_scan",
                        [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                         _cuda.I64, _cuda.I32, _cuda.I32, _cuda.I32,
                         _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P])
    err = fn(None if head_count is None else head_count.data_ptr(),
             x.data_ptr(), out.data_ptr(), state.data_ptr(), desc.data_ptr(),
             q, c, code, plan.vw, plan.w, plan.ntiles, plan.ncb,
             _cuda.stream_ptr())
    _cuda.check("seg_scan", err, "sorted_segment_scan")
    _cuda.count_launch("sorted_segment_scan")
    return out


def seg_sum_tails(head_count: torch.Tensor, x: torch.Tensor,
                  tails: torch.Tensor) -> torch.Tensor:
    """K3: per-run totals of ``x`` at the ``tails`` row positions.

    Args:
      head_count: (Q,) int32 nondecreasing run ids.
      x: (Q, C) float32.
      tails: (B,) int64 row positions; each result is the sum of x from its
        run's head to the tail row (positions outside [0, Q) give 0).
    Returns (B, C) float32.
    """
    _check(head_count, x, (torch.float32,), "seg_sum_tails")
    if tails.dim() != 1 or tails.dtype != torch.int64 \
            or tails.device != x.device:
        raise ValueError("seg_sum_tails: tails must be (B,) int64 on x's "
                         "device")
    if x.device.type == "cpu":
        return seg_sum_tails_plain(head_count, x, tails)
    if not tails.is_contiguous():
        raise ValueError("seg_sum_tails: tails must be contiguous")
    q, c = x.shape
    b = tails.shape[0]
    if q == 0 or b == 0 or c == 0:
        return torch.zeros((b, c), dtype=torch.float32, device=x.device)
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    plan = _lookback_plan(q, c, c % 4 == 0 and x.data_ptr() % 16 == 0)
    ends = torch.empty_like(x)          # only run-end rows are written
    state, desc = _lookback_scratch(plan, x)
    fn = _cuda.function("seg_sum_tails", "tln_seg_sum_tails",
                        [_cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
                         _cuda.I64, _cuda.P, _cuda.P, _cuda.P, _cuda.I32,
                         _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P, _cuda.P])
    err = fn(head_count.data_ptr(), x.data_ptr(), tails.data_ptr(), q, c, b,
             ends.data_ptr(), state.data_ptr(), desc.data_ptr(), plan.vw,
             plan.w, plan.ntiles, plan.ncb, out.data_ptr(), _cuda.stream_ptr())
    _cuda.check("seg_sum_tails", err, "seg_sum_tails")
    _cuda.count_launch("seg_sum_tails")
    return out


def sorted_segment_max_u32(head_count: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """K4: inclusive segmented running max of uint32 bit patterns held in an
    int32 (Q, C) tensor (compared as unsigned)."""
    _check(head_count, x, (torch.int32,), "sorted_segment_max_u32")
    if x.device.type == "cpu":
        return sorted_segment_max_u32_plain(head_count, x)
    q, c = x.shape
    out = torch.empty_like(x)
    if q == 0 or c == 0:
        return out
    plan = _lookback_plan(q, c, c % 4 == 0 and x.data_ptr() % 16 == 0)
    # the tile state, then a 64-bit descriptor word per (tile, channel)
    state = torch.empty(plan.state_words + plan.ntiles * c,
                        dtype=torch.int64, device=x.device)
    fn = _cuda.function("seg_max", "tln_seg_max",
                        [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64,
                         _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
                         _cuda.I32, _cuda.P])
    err = fn(head_count.data_ptr(), x.data_ptr(), out.data_ptr(),
             state.data_ptr(), q, c, plan.vw, plan.w, plan.ntiles, plan.ncb,
             _cuda.stream_ptr())
    _cuda.check("seg_max", err, "sorted_segment_max_u32")
    _cuda.count_launch("sorted_segment_max_u32")
    return out


def sorted_segment_max_window(head_count: torch.Tensor, x: torch.Tensor,
                              window=None) -> torch.Tensor:
    """K5: windowed inclusive segmented running max of uint32 bit patterns
    held in an int32 (Q, C) tensor.

    Row r holds the max over rows [max(head(r), r - 2 window + 1), r] of its
    run: every row covers its last ``2 * window`` same-run rows and never
    crosses a run head.  ``window`` is 1 to :data:`MAX_WINDOW`; ``None``
    (the whole run) is K4's function and launches K4."""
    if window is None:
        return sorted_segment_max_u32(head_count, x)
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"sorted_segment_max_window: window must be in "
                         f"[1, {MAX_WINDOW}] or None, got {window}")
    _check(head_count, x, (torch.int32,), "sorted_segment_max_window")
    if x.shape[1] > 64:
        raise ValueError("sorted_segment_max_window: C must be <= 64, got "
                         f"{x.shape[1]}")
    if x.device.type == "cpu":
        return sorted_segment_max_window_plain(head_count, x, window)
    q, c = x.shape
    out = torch.empty_like(x)
    fn = _cuda.function("seg_max_window", "tln_seg_max_window",
                        [_cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I32,
                         _cuda.I32, _cuda.P])
    err = fn(head_count.data_ptr(), x.data_ptr(), out.data_ptr(), q, c,
             window, _cuda.stream_ptr())
    _cuda.check("seg_max_window", err, "sorted_segment_max_window")
    _cuda.count_launch("sorted_segment_max_window")
    return out
