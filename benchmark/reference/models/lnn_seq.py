"""Frozen copy of the port's ``models/lnn_seq.py`` (plain PyTorch only: no CUDA
kernel, no import of the port).  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.

Original docstring:

LNN_SEQ: the temporal permutohedral-lattice U-Net (port of the JAX
package's ``models/lnn_seq.py``).

Per frame: PointNet early fusion + first conv -> down path with middle
fusion at level 0 -> bottleneck blocks + bottleneck fusion -> up path with
late fusion at the finest level -> up resnets -> deform slice ->
log-softmax.  ``final=False`` stops after the last active fusion site and
only returns the updated temporal state (the reference's early return).
Quirk kept: the up-stage resnet blocks sit outside the upsample loop in the
reference, so only the final stage's blocks run.

A frame takes its lattice structure from the precomputed whole-sequence
lattice of ``ops.seq_lattice`` and its own ``DistributeOut``; the pointnet
runs per frame.  (The port's streaming paths build the same structures
frame by frame; the benchmark compares their answers with this one.)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..config import ModelConfig, RuntimeConfig
from .blocks import (BottleneckBlock, DeformSlice, GnReluCoarsen, GnReluFinefy,
                     ResnetBlock)
from .fusion import make_fusion
from .pointnet import PointNetSeq

SITES = ("early", "middle", "bottleneck", "late")


@dataclasses.dataclass
class SeqState:
    """Temporal carry: hidden values per fusion site, the site level's vertex
    count when each was written, and the frame index."""

    h: Tuple[torch.Tensor, ...]
    prev_counts: Tuple[object, ...]
    t: int


def site_level(cfg: ModelConfig, site: str) -> int:
    return cfg.nr_downsamples if site == "bottleneck" else 0


def site_channels(cfg: ModelConfig, site: str) -> int:
    return {"early": cfg.early_channels, "middle": cfg.middle_channels,
            "bottleneck": cfg.bottleneck_channels,
            "late": cfg.late_channels}[site]


def init_state(cfg: ModelConfig, rt: RuntimeConfig, device) -> SeqState:
    """Fresh sequence state (zero hidden values at full capacity)."""
    caps = rt.capacities(cfg.nr_downsamples)
    h = []
    for site, kind in zip(SITES, cfg.rnn_modules):
        if cfg.sequence_learning and kind != "none":
            h.append(torch.zeros((caps[site_level(cfg, site)],
                                  site_channels(cfg, site)), device=device))
        else:
            h.append(torch.zeros((1, 1), device=device))
    return SeqState(h=tuple(h), prev_counts=(1,) * len(SITES), t=0)


def _last_active_site(cfg: ModelConfig) -> int:
    last = -1
    for i, kind in enumerate(cfg.rnn_modules):
        if kind != "none":
            last = i
    return last


class LNNSeq(nn.Module):
    """The model; parameters are created on ``device`` (default ``cuda``)
    from a seeded ``torch.Generator``."""

    def __init__(self, cfg: ModelConfig, rt: RuntimeConfig, device=None,
                 seed: int = 0, n_values: int = 1):
        super().__init__()
        self.device = torch.device("cpu" if device is None else device)
        self.cfg, self.rt = cfg, rt
        L = cfg.nr_downsamples
        cd = cfg.compute_dtype
        seq = cfg.sequence_learning
        self.point_net_seq = PointNetSeq(cfg, n_values)

        self.resnet_blocks_per_down_lvl_list = nn.ModuleList()
        self.coarsens_list = nn.ModuleList()
        cur = cfg.pointnet_start_nr_channels
        skip_ch = []
        for i in range(L):
            blocks = nn.ModuleList()
            for _ in range(cfg.nr_blocks_down_stage[i]):
                if i < cfg.nr_levels_down_with_normal_resnet:
                    blocks.append(ResnetBlock(cur, (False, False), cd))
                else:
                    blocks.append(BottleneckBlock(cur, (False,) * 3, cd))
            self.resnet_blocks_per_down_lvl_list.append(blocks)
            skip_ch.append(cur)
            nxt = int(cur * 2 * cfg.compression_factor)
            self.coarsens_list.append(GnReluCoarsen(cur, nxt, cd))
            cur = nxt
        self.resnet_blocks_bottleneck = nn.ModuleList(
            BottleneckBlock(cur, (False,) * 3, cd)
            for _ in range(cfg.nr_blocks_bottleneck))
        bottleneck_ch = cur

        self.finefy_list = nn.ModuleList()
        self.resnet_blocks_per_up_lvl_list = nn.ModuleDict()
        up_in = []
        for i in range(L):
            nf = cur // 2
            self.finefy_list.append(GnReluFinefy(cur, nf, cd))
            cur = nf + skip_ch[L - 1 - i]
            up_in.append(cur)
        i = L - 1
        final_blocks = nn.ModuleList()
        for j in range(cfg.nr_blocks_up_stage[i]):
            last = j == cfg.nr_blocks_up_stage[i] - 1
            if i >= L - cfg.nr_levels_up_with_normal_resnet:
                final_blocks.append(ResnetBlock(cur, (False, last), cd))
            else:
                final_blocks.append(BottleneckBlock(cur, (False, False, last),
                                                    cd))
        self.resnet_blocks_per_up_lvl_list[str(i)] = final_blocks

        # middle / bottleneck / late fusion, named by slot
        inputs = {1: skip_ch[0], 2: bottleneck_ch, 3: up_in[-1]}
        self.recurrent_fusion_modules = nn.ModuleDict()
        for i, site in enumerate(SITES[1:], start=1):
            kind = cfg.rnn_modules[i] if seq else "none"
            if kind != "none":
                self.recurrent_fusion_modules[str(i - 1)] = make_fusion(
                    kind, site_channels(cfg, site), cfg,
                    input_size=inputs[i])

        self.slice_fast_cuda = DeformSlice(cur, cfg.nr_classes)
        self.init_weights(seed)
        self.to(self.device)

    def init_weights(self, seed: int = 0) -> None:
        """Re-initialise every parameter from ``torch.Generator(seed)``, with
        the JAX package's distributions."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if mod is not self and hasattr(mod, "init_weights"):
                mod.init_weights(gen)

    def _fusion(self, slot: int):
        key = str(slot)
        return (self.recurrent_fusion_modules[key]
                if key in self.recurrent_fusion_modules else None)

    def forward(self, state: SeqState, seqlat, dist, final: bool = True,
                values=None):
        """One frame of the sequence lattice ``seqlat``: its
        ``DistributeOut`` ``dist`` and its (P, V) point ``values``.
        Returns (the final frame's (logp, logits) or None, new state,
        aux)."""
        cfg, rt = self.cfg, self.rt
        L = cfg.nr_downsamples
        t = state.t
        is_first = t == 0
        seq = cfg.sequence_learning
        cut = _last_active_site(cfg) if seq else 3
        h = list(state.h)
        pc = list(state.prev_counts)
        nbrs = [seqlat.frame_nbr(l, t) for l in range(L + 1)]
        links = list(seqlat.links)
        counts = [seqlat.levels[l].counts[t] for l in range(L + 1)]

        def pack_state():
            return SeqState(h=tuple(h), prev_counts=tuple(pc), t=t + 1)

        early_out = {"point_vertex": dist.point_vertex}
        values_rows = (values.repeat_interleave(4, dim=0)
                       * dist.row_valid[:, None])
        # the sequence lattice counts each vertex's rows in its build
        reduced = self.point_net_seq.reduce_frame(
            dist, values_rows, nbrs[0].idx.shape[0], seqlat.nr_points[t])
        lv, h[0] = self.point_net_seq.fuse_and_conv(
            reduced, nbrs[0], counts[0], h[0], pc[0], is_first)
        pc[0] = counts[0]
        if (not final) and seq and cut <= 0:
            return None, pack_state(), early_out

        # ---- down path -------------------------------------------------
        skip_values, skip_counts = [], []
        for i in range(L):
            for block in self.resnet_blocks_per_down_lvl_list[i]:
                lv = block(lv, nbrs[i], counts[i])
            skip_values.append(lv)
            skip_counts.append(counts[i])
            if i == 0:
                fusion = self._fusion(0)
                if fusion is not None:
                    lv, h[1] = fusion(lv, h[1], pc[1], counts[0], is_first,
                                      nbrs[0])
                    pc[1] = counts[0]
                if (not final) and seq and cut <= 1:
                    return None, pack_state(), early_out
            lv = self.coarsens_list[i](lv, counts[i], links[i], nbrs[i + 1],
                                       counts[i + 1])

        # ---- bottleneck ------------------------------------------------
        for block in self.resnet_blocks_bottleneck:
            lv = block(lv, nbrs[L], counts[L])
        fusion = self._fusion(1)
        if fusion is not None:
            lv, h[2] = fusion(lv, h[2], pc[2], counts[L], is_first, nbrs[L])
            pc[2] = counts[L]
        if (not final) and seq and cut <= 2:
            return None, pack_state(), early_out

        # ---- up path ---------------------------------------------------
        for i in range(L):
            lvl = L - 1 - i
            fine_v = skip_values.pop()
            skip_counts.pop()
            up = self.finefy_list[i](lv, counts[lvl + 1], nbrs[lvl + 1],
                                     links[lvl], counts[lvl])
            lv = torch.cat([up, fine_v], dim=-1)
            if i == L - 1:
                fusion = self._fusion(2)
                if fusion is not None:
                    lv, h[3] = fusion(lv, h[3], pc[3], counts[0], is_first,
                                      nbrs[0])
                    pc[3] = counts[0]
                if not final and seq:
                    return None, pack_state(), early_out

        # reference quirk: only the final stage's up resnets run, at level 0
        for block in self.resnet_blocks_per_up_lvl_list[str(L - 1)]:
            lv = block(lv, nbrs[0], counts[0])

        sv = self.slice_fast_cuda(lv, dist.point_vertex, dist.point_bary)
        logp = torch.log_softmax(sv, dim=-1)
        caps = rt.capacities(L)
        occupancy = torch.stack([torch.as_tensor(counts[l])
                                 for l in range(L + 1)])
        aux = {"nr_vertices": counts[0], "occupancy": occupancy,
               "vertex_overflow": torch.stack(
                   [counts[l] >= caps[l] for l in range(L + 1)]).any(),
               "point_vertex": dist.point_vertex}
        return (logp, sv), pack_state(), aux
