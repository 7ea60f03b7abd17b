"""Offline sequence forward (port of the JAX package's
``train/engine.make_sequence_forward(precompute=True)``).

The whole sequence's lattice is built in one birth-tagged pass
(``ops/seq_lattice``), the pointnet MLP + max runs once for all frames over
the union-sorted rows, frames 0..T-2 run the trimmed early-return network on
row prefixes of the lattice (a Python loop in place of ``lax.scan``), and
the final frame runs the full model on its own trimmed view.  The streaming
per-frame path (``precompute=False``) is not ported.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, RuntimeConfig
from ..models.lnn_seq import SITES, LNNSeq, init_state, site_level
from ..ops import lattice_ops as lo
from ..ops import seq_lattice as sl


def _resize_rows(a: torch.Tensor, c: int) -> torch.Tensor:
    """Slice or zero-pad the row axis to c; exact either way because fusion
    outputs are zero past the frame's count."""
    if a.shape[0] >= c:
        return a[:c]
    return torch.nn.functional.pad(a, (0, 0, 0, c - a.shape[0]))


def sequence_lattice(cfg: ModelConfig, rt: RuntimeConfig,
                     positions: torch.Tensor, values: torch.Tensor,
                     mask: torch.Tensor):
    """The whole sequence's lattice as the offline forward builds it.

    Returns ``(seqlat, trim_caps, final_caps)``: the row prefixes that the
    non-final frames and the final frame run on, each None when that view
    is not trimmed."""
    L = cfg.nr_downsamples
    caps = rt.capacities(L)
    t = positions.shape[0]
    trim_caps = rt.trim_capacities(L)
    if not (trim_caps is not None and t > 1
            and any(tc < c for tc, c in zip(trim_caps, caps))):
        trim_caps = None
    final_caps = rt.final_capacities(L)
    if not (final_caps is not None
            and any(fc < c for fc, c in zip(final_caps, caps))):
        final_caps = None
    nbr_caps = None
    if final_caps is not None and trim_caps is not None:
        nbr_caps = tuple(max(tc, fc) for tc, fc in zip(trim_caps, final_caps))
    elif final_caps is not None and t == 1:
        nbr_caps = final_caps
    seqlat = sl.build_sequence_lattice(
        positions, mask, rt.sigma, caps, L, nbr_caps=nbr_caps,
        pn_values=values if values.shape[-1] <= 3 else None,
        want_row_rel=False)
    return seqlat, trim_caps, final_caps


def make_sequence_forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                          precompute: bool = True):
    """Single-sequence forward: (positions (T,P,3), values (T,P,V),
    mask (T,P)) -> (logp (P, classes), logits, aux) for the last frame.

    Inputs may be numpy arrays or tensors; they move to the model's device.
    """
    if not precompute:
        raise NotImplementedError(
            "the streaming per-frame path is not ported to PyTorch yet")
    if not (rt.batched_pointnet and cfg.experiment == "none"
            and cfg.compute_dtype == "bfloat16"):
        raise NotImplementedError(
            "only the batched pointnet path (bf16, experiment 'none') is "
            "ported to PyTorch yet")
    L = cfg.nr_downsamples
    dev = model.device

    def site_caps(which):
        return [which[site_level(cfg, s)] for s in SITES]

    @torch.no_grad()
    def seq_forward(positions, values, mask):
        positions = torch.as_tensor(positions, device=dev)
        values = torch.as_tensor(values, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        state = init_state(cfg, rt, dev)
        t = positions.shape[0]
        seqlat, trim_caps, final_caps = sequence_lattice(
            cfg, rt, positions, values, mask)
        # undersized trim caps exclude late-born vertices: surfaced, never
        # silent
        over = []
        if trim_caps is not None:
            over += [seqlat.levels[l].counts[-2] > trim_caps[l]
                     for l in range(L + 1)]
        if final_caps is not None:
            over += [seqlat.levels[l].counts[-1] > final_caps[l]
                     for l in range(L + 1)]
        trim_overflow = (torch.stack(over).any() if over
                         else torch.zeros((), dtype=torch.bool, device=dev))

        full_dist = lo.DistributeOut(
            row_vertex=seqlat.row_vertex, row_bary=seqlat.row_bary,
            row_rel_pos=seqlat.row_rel_pos, row_valid=seqlat.row_valid,
            point_vertex=seqlat.point_vertex, point_bary=seqlat.point_bary)
        reduced_all = model.reduce_pointnet(seqlat, values)

        if t > 1:
            if trim_caps is not None:
                scan_lat = sl.trim_sequence_lattice(seqlat, trim_caps)
                red_scan = reduced_all[:-1, : trim_caps[0]]
                state.h = tuple(a[:c] if a.shape[0] > 1 else a
                                for a, c in zip(state.h, site_caps(trim_caps)))
            else:
                scan_lat, red_scan = seqlat, reduced_all[:-1]
            for f in range(t - 1):
                _, state, _ = model(state, scan_lat, full_dist.frame(f),
                                    red_scan[f], final=False)
        if trim_caps is not None or final_caps is not None:
            target = site_caps(final_caps if final_caps is not None
                               else rt.capacities(L))
            state.h = tuple(_resize_rows(a, c) if a.shape[0] > 1 else a
                            for a, c in zip(state.h, target))
        if final_caps is not None:
            final_lat = sl.trim_sequence_lattice(seqlat, final_caps)
            red_final = reduced_all[-1, : final_caps[0]]
        else:
            final_lat, red_final = seqlat, reduced_all[-1]
        (logp, sv), state, aux = model(state, final_lat, full_dist.frame(t - 1),
                                       red_final, final=True)
        aux["trim_overflow"] = trim_overflow
        aux["vertex_overflow"] = aux["vertex_overflow"] | trim_overflow
        return logp, sv, aux

    return seq_forward
