"""Frozen copy of the plain versions of the port's ``ops/seg_scan.py``
(no CUDA kernel, no import of the port).  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.

Segmented scans over contiguous runs of sorted rows, given by nondecreasing
run ids (``head_count``): rows with equal ids form one run.  The port runs
them as kernels K2 (:func:`sorted_segment_scan`: an inclusive segmented
``sum``, or ``first``, the run head's value copied forward; ``sum`` with
``head_count=None`` is a cumsum over every row) and K3
(:func:`seg_sum_tails`: exact per-run totals at the given tail rows).
"""

from __future__ import annotations

import torch


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


def sorted_segment_scan(head_count, x, mode):
    if head_count is None and mode == "sum":      # one run: a cumsum
        acc_t = torch.float64 if x.dtype.is_floating_point else torch.int64
        return torch.cumsum(x.to(acc_t), dim=0).to(x.dtype)
    if mode == "first":
        return x[_head_positions(head_count)]
    if mode == "sum":
        rows = torch.arange(x.shape[0], device=x.device)
        return _run_sums_at(head_count, x, rows)
    raise ValueError(mode)


def seg_sum_tails(head_count, x, tails):
    q = x.shape[0]
    ok = (tails >= 0) & (tails < q)
    t = tails.clamp(0, max(q - 1, 0))
    out = _run_sums_at(head_count, x, t)
    return torch.where(ok[:, None], out, torch.zeros_like(out))
