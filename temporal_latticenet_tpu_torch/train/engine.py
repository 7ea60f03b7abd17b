"""Sequence forwards, streaming inference and the BPTT training step (port
of the JAX package's ``train/engine.py``: ``make_sequence_forward``,
``make_streaming_inference`` and its incremental and batched forms,
``create_train_state`` and ``make_train_step``).

The whole sequence's lattice is built in one birth-tagged pass
(``ops/seq_lattice``); with ``RuntimeConfig.batched_pointnet`` in bf16 and
no experiment ablation the pointnet MLP + max runs once for all frames over
the union-sorted rows, otherwise (the non-batched route, every float32
configuration and every experiment) each frame runs it over its own rows
of the lattice.  The no-local-mean experiments build the lattice and
distribute without the local mean.  Frames 0..T-2 run the
trimmed early-return network on row prefixes of the lattice (a Python loop
in place of ``lax.scan``), and the final frame runs the full model on its
own trimmed view.  On the card the offline forward serves each sequence by
replaying two CUDA graphs of its own code, one of the sequence lattice and
one of the network over it; it makes no host sync, so the host launches
two graphs a sequence instead of some 4,700 operations.  The training
step differentiates that forward end to end (backpropagation through time
over the carried fusion states) under the loss of ``models/losses.py`` and
takes one AdamW(amsgrad) step; on the card the step's gradients are
served by replaying a lattice and a network graph (the network graph holds
the forward, the loss and the backward), with AdamW run eagerly after
them.  The slice head's dropout (``dropout_last_layer``) runs in the
training step's final frame only, from a generator seeded by the step
count and the sequence's index in the batch.
A batch of B sequences takes the mean of their losses, with the gradient
summed one sequence at a time; under a ``parallel.mesh.Mesh`` the ranks
split the batch and all-reduce the gradient (data parallelism).

Streaming inference serves one scan at a time, as a deployed system does:
the vertex tables and fusion states carry over between frames, and each
frame is distributed onto the tables (kernel K1) and runs the network on
per-frame structures, built in full every frame or, on the incremental
path, updated for the new vertices only.  Its steps keep every count on the
device: no step reads a tensor on the host.  On the card the plain path
serves its frames by replaying CUDA graphs of the frame's own code (one of
the lattice part, one of the network part), so that the host launches two
graphs a frame instead of some 2,000 operations.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, RuntimeConfig
from ..device import resolve_device
from ..models.lnn_seq import SITES, LNNSeq, SeqState, init_state, site_level
from ..models.pointnet import subtract_local_mean
from ..models.losses import segmentation_loss
from ..ops import lattice_ops as lo
from ..ops import segment
from ..ops import seq_lattice as sl
from ..parallel import mesh as pmesh
from ..utils.profiling import span, without_spans
from . import optim

REMAT_MODES = ("none", "selective", "full")

# the unit number each entry point's span carries (``utils/profiling``)
_UNITS = itertools.count()


def _resize_rows(a: torch.Tensor, c: int) -> torch.Tensor:
    """Slice or zero-pad the row axis to c; exact either way because fusion
    outputs are zero past the frame's count."""
    if a.shape[0] >= c:
        return a[:c]
    return torch.nn.functional.pad(a, (0, 0, 0, c - a.shape[0]))


DROPOUT_SEED = 0x5EED   # the dropout generator's seed, beside the step


def batched_pointnet(cfg: ModelConfig, rt: RuntimeConfig) -> bool:
    """Whether the offline forward runs the pointnet for all frames at once
    over the union-sorted rows (bf16 without an experiment ablation, as in
    the JAX package)."""
    return (rt.batched_pointnet and cfg.compute_dtype == "bfloat16"
            and cfg.experiment == "none")


def dropout_generator(device, step: int, index: int = 0) -> torch.Generator:
    """The generator of one training step's dropout mask for the sequence
    at ``index`` of the (global) batch, on ``device``: seeded by the step
    count and the index, so that a resumed run, and ranks that split the
    batch, draw the masks one process would have drawn.  The index is
    mixed into the seed's low 32 bits, the only ones the CPU's Mersenne
    Twister reads; index 0 gives the seed of a batch of one."""
    low = (int(step) + int(index) * 0x9E3779B9) & 0xFFFFFFFF
    return torch.Generator(device=device).manual_seed(
        (DROPOUT_SEED << 32) + low)


def sequence_lattice(cfg: ModelConfig, rt: RuntimeConfig,
                     positions: torch.Tensor, values: torch.Tensor,
                     mask: torch.Tensor):
    """The whole sequence's lattice as the offline forward builds it.

    Returns ``(seqlat, trim_caps, final_caps)``: the row prefixes that the
    non-final frames and the final frame run on, each None when that view
    is not trimmed.  The batched pointnet's values ride the union's sorts;
    the per-frame route reads every row's relative position instead."""
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
    batched = batched_pointnet(cfg, rt)
    seqlat = sl.build_sequence_lattice(
        positions, mask, rt.sigma, caps, L,
        subtract_local_mean=subtract_local_mean(cfg), nbr_caps=nbr_caps,
        pn_values=values if batched and values.shape[-1] <= 3 else None,
        want_row_rel=not batched)
    return seqlat, trim_caps, final_caps


def _remat_frame(fn, remat: str):
    """Full remat: each frame's network is recomputed in the backward
    (``jax.checkpoint`` around the frame in the JAX package)."""
    if remat != "full":
        return fn

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        # no randomness inside: the rng state need not be kept
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return wrapped


def _sequence_parts(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                    remat: str):
    """The sequence forward's two halves, on device tensors:
    ``lattice(positions, values, mask)`` -> the sequence lattice's
    structures (``sequence_lattice``, the trim overflow flag and every
    frame's ``DistributeOut``), and ``network(structures, values,
    dropout_gen)`` -> (logp, logits, aux) of the last frame."""
    batched = batched_pointnet(cfg, rt)
    L = cfg.nr_downsamples
    dev = model.device
    frame = _remat_frame(model, remat)

    def site_caps(which):
        return [which[site_level(cfg, s)] for s in SITES]

    def lattice(positions, values, mask):
        # the lattice is integer structure and point geometry: nothing in
        # it is differentiated
        with torch.no_grad():
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
        return (seqlat, trim_caps, final_caps, trim_overflow,
                seqlat.distribute_out())

    def network(structures, values, dropout_gen):
        seqlat, trim_caps, final_caps, trim_overflow, full_dist = structures
        state = init_state(cfg, rt, dev)
        t = values.shape[0]
        with lo.remat_conv_rows(remat == "selective"):
            # per frame: the batched pointnet's reduced slice, or None (the
            # frame runs the pointnet over its own rows)
            reduced_all = (model.reduce_pointnet(seqlat, values) if batched
                           else [None] * t)

            if t > 1:
                if trim_caps is not None:
                    with torch.no_grad():
                        scan_lat = sl.trim_sequence_lattice(seqlat, trim_caps)
                    red_scan = (reduced_all[:-1, : trim_caps[0]] if batched
                                else reduced_all[:-1])
                    state.h = tuple(
                        a[:c] if a.shape[0] > 1 else a
                        for a, c in zip(state.h, site_caps(trim_caps)))
                else:
                    scan_lat, red_scan = seqlat, reduced_all[:-1]
                for f in range(t - 1):
                    _, state, _ = frame(state, scan_lat, full_dist.frame(f),
                                        red_scan[f], final=False,
                                        values=values[f])
            if trim_caps is not None or final_caps is not None:
                target = site_caps(final_caps if final_caps is not None
                                   else rt.capacities(L))
                state.h = tuple(_resize_rows(a, c) if a.shape[0] > 1 else a
                                for a, c in zip(state.h, target))
            if final_caps is not None:
                with torch.no_grad():
                    final_lat = sl.trim_sequence_lattice(seqlat, final_caps)
                red_final = (reduced_all[-1, : final_caps[0]] if batched
                             else None)
            else:
                final_lat, red_final = seqlat, reduced_all[-1]
            keep = None
            if dropout_gen is not None and cfg.dropout_last_layer > 0:
                keep = model.slice_fast_cuda.dropout_keep(values.shape[1],
                                                          dropout_gen)
            (logp, sv), state, aux = frame(state, final_lat,
                                           full_dist.frame(t - 1), red_final,
                                           final=True, values=values[-1],
                                           dropout_keep=keep)
        if keep is not None:
            aux["dropped_share"] = 1.0 - keep.float().mean()
        aux["trim_overflow"] = trim_overflow
        aux["vertex_overflow"] = aux["vertex_overflow"] | trim_overflow
        return logp, sv, aux

    return lattice, network


def sequence_forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                     remat: str = "none"):
    """Single-sequence forward with gradients: (positions (T,P,3), values
    (T,P,V), mask (T,P), dropout_gen=None) -> (logp (P, classes), logits,
    aux) for the last frame.  With a ``dropout_gen`` and
    ``dropout_last_layer > 0``, the final frame's slice head drops features
    by a mask drawn from it before the frame runs (so that a recomputed
    frame drops the same ones); ``aux["dropped_share"]`` is the mask's
    dropped share.

    ``remat`` sets what the backward recomputes instead of keeping:
      "none"      -- keep every activation;
      "selective" -- keep everything except each lattice convolution's
                     (C, 9*Cin) rowified rows (``lattice_ops.remat_conv_rows``);
      "full"      -- keep only each frame's inputs and recompute the frame.

    Inputs may be numpy arrays or tensors; they move to the model's device.
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    lattice, network = _sequence_parts(model, cfg, rt, remat)

    def seq_forward(positions, values, mask, dropout_gen=None):
        with span("tln.engine.sequence", unit=next(_UNITS), graph=0):
            p, v, m = _frame_inputs(model.device, positions, values, mask)
            return network(lattice(p, v, m), v, dropout_gen)

    return seq_forward


# ---------------------------------------------------------------------------
# CUDA graph replay of a unit of work
# ---------------------------------------------------------------------------

def _tree_map(fn, x):
    """``x`` rebuilt with ``fn`` applied to each tensor leaf: tuples, lists,
    dicts, NamedTuples and dataclasses are walked, anything else passes
    through."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        items = [_tree_map(fn, y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    if isinstance(x, dict):
        return {k: _tree_map(fn, y) for k, y in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def _leaves(x) -> list:
    """The tensor leaves of ``x``, in :func:`_tree_map`'s order."""
    out = []
    _tree_map(out.append, x)
    return out


def _cloner():
    """A clone function for :func:`_tree_map` that clones each tensor once,
    so that outputs which share a tensor (a fusion site's count is its
    level's table count) share its clone."""
    memo = {}

    def clone(x):
        if id(x) not in memo:
            memo[id(x)] = x.clone()
        return memo[id(x)]
    return clone


def _copy_in(static, args, copied: dict) -> dict:
    """Copy each tensor leaf of ``args`` into its buffer, the same leaf of
    ``static``, unless that buffer already holds that very tensor
    (``copied``: buffer id -> the tensor copied in; updated and
    returned)."""
    for dst, src in zip(_leaves(static), _leaves(args), strict=True):
        if copied.get(id(dst)) is not src:
            dst.copy_(src)
            copied[id(dst)] = src
    return copied


def _capture(fn, pool):
    """``fn()`` captured as a CUDA graph whose memory comes from ``pool``.
    Returns (the graph, fn's outputs: tensors that each replay writes
    anew)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


class _UnitGraphs:
    """One key's two CUDA graphs, ``lattice(*a)`` and ``network(structures,
    *b)`` over its outputs, captured from one pool, and their static
    buffers: a copy of every tensor leaf of ``a`` and ``b``, one for a
    tensor that both hold.  The network graph reads the lattice graph's
    outputs in place, so the two replay in turn with nothing in between;
    the outputs are cloned before anything else replays."""

    def __init__(self, lattice, network, a, b, pool):
        clone = _cloner()
        self.a, self.b = _tree_map(clone, a), _tree_map(clone, b)
        with without_spans():
            self.lattice, structures = _capture(lambda: lattice(*self.a),
                                                pool)
            self.network, self.out = _capture(
                lambda: network(structures, *self.b), pool)

    def __call__(self, a, b, unit: str, ids: dict):
        """The unit's outputs, all fresh tensors: ``a`` copied in and the
        lattice graph replayed inside ``tln.lattice.<unit>``, then ``b``
        copied in, the network graph replayed and the outputs cloned inside
        ``tln.model.<unit>``.  Non-tensor leaves are the captured unit's."""
        with span(f"tln.lattice.{unit}", **ids):
            copied = _copy_in(self.a, a, {})
            self.lattice.replay()
        with span(f"tln.model.{unit}", **ids):
            _copy_in(self.b, b, copied)
            self.network.replay()
            return _tree_map(_cloner(), self.out)


class _GraphCache:
    """Serve-or-capture of one unit of work (a sequence, a frame, a
    training step's gradients) as CUDA graphs.  A subclass gives the unit's
    ``key`` and its ``parts``: ``(lattice, network, a, b)``, the unit being
    ``network(lattice(*a), *b)``; ``unit`` names the spans of its two
    parts, ``tln.lattice.<unit>`` and ``tln.model.<unit>``.

    A unit's work is fixed by its key.  The first unit of a key runs
    eagerly (its warm-up: every lazily made constant and library handle
    exists afterwards), then the key's graphs are captured
    (:class:`_UnitGraphs`), all from one memory pool, with spans muted;
    every later unit of the key copies its inputs into the graphs' static
    buffers and replays them.  Units run eagerly where :meth:`replayable`
    says no.

    ``counts``: ``captures`` (keys captured), ``replays`` and ``eager``
    (units served each way)."""

    unit = None

    def __init__(self, model: LNNSeq):
        self.model = model
        self.card = model.device.type == "cuda"
        self.graphs = {}
        self.pool = None
        self.counts = {"captures": 0, "replays": 0, "eager": 0}

    def replayable(self) -> bool:
        """Whether a unit may be served from graphs now: on the card
        (``card``, the model's device), with gradients off (a replay
        records no autograd graph) and outside ``LNNSeq.sow_aux`` (a replay
        makes no Python-side records)."""
        return (self.card and not torch.is_grad_enabled()
                and not self.model.sowing)

    def __call__(self, name: str, args: tuple, then=None, **ids):
        """Serve one unit, ``args``, inside the engine span ``name`` (with
        ``ids`` and ``graph``: 1 for a replay, 0 for an eager unit); the
        spans of its parts carry ``ids`` too.  With ``then``, the result is
        ``then(outputs)``, run inside the engine span after the unit and
        any capture of its key."""
        replayable = self.replayable()
        key = self.key(*args) if replayable else None
        graphs = self.graphs.get(key)
        lattice, network, a, b = self.parts(*args)
        with span(name, unit=next(_UNITS), graph=int(graphs is not None),
                  **ids):
            if graphs is not None:
                self.counts["replays"] += 1
                out = graphs(a, b, self.unit, ids)
            else:
                self.counts["eager"] += 1
                with span(f"tln.lattice.{self.unit}", **ids):
                    structures = lattice(*a)
                out = network(structures, *b)
                if replayable:
                    if self.pool is None:
                        self.pool = torch.cuda.graph_pool_handle()
                    self.graphs[key] = _UnitGraphs(lattice, network, a, b,
                                                   self.pool)
                    self.counts["captures"] += 1
            return out if then is None else then(out)


class SequenceGraphs(_GraphCache):
    """The offline sequence forward as CUDA graphs (:class:`_GraphCache`):
    the sequence lattice (its structures and every frame's
    ``DistributeOut``), then the network over it (the batched pointnet and
    every frame of the model), :func:`_sequence_parts`.

    A sequence's key: the shapes and dtypes of its positions, values and
    mask (the forward's other Python-side branches, the trim capacities,
    follow from the runtime config and the number of frames) and the
    pointnet max's route."""

    unit = "sequence"

    def __init__(self, model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig):
        super().__init__(model)
        self.lattice, self.network = _sequence_parts(model, cfg, rt, "none")

    def key(self, p, v, m):
        return (tuple((x.shape, x.dtype) for x in (p, v, m)),
                segment.packed_route())

    def parts(self, p, v, m):
        return self.lattice, self.network, (p, v, m), (v, None)


def make_sequence_forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                          precompute: bool = True):
    """The inference entry point, with gradients off.  Single sequence:
    (positions (T,P,3), values (T,P,V), mask (T,P)) -> (logp (P, classes),
    logits, aux) for the last frame.  ``precompute=True`` is
    :func:`sequence_forward` over the whole-sequence lattice, which on the
    card replays the CUDA graphs of the sequence's key
    (:class:`SequenceGraphs`, ``seq_forward.graphs``); every tensor returned
    is fresh.  ``precompute=False`` steps :func:`make_streaming_inference`
    through the frames."""
    if not precompute:
        new_state_fn, step_fn, final_fn = make_streaming_inference(model, cfg,
                                                                   rt)

        def stream_forward(positions, values, mask):
            state = new_state_fn()
            for f in range(len(positions) - 1):
                state = step_fn(positions[f], values[f], mask[f], state)
            logp, sv, _, aux = final_fn(positions[-1], values[-1], mask[-1],
                                        state)
            return logp, sv, aux
        return stream_forward
    cache = SequenceGraphs(model, cfg, rt)

    @torch.no_grad()
    def seq_forward(positions, values, mask):
        return cache("tln.engine.sequence",
                     _frame_inputs(model.device, positions, values, mask))

    seq_forward.graphs = cache
    return seq_forward


# ---------------------------------------------------------------------------
# streaming inference
# ---------------------------------------------------------------------------

def _frame_inputs(dev, positions, values, mask):
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (positions, values, mask))


def _advance(cfg: ModelConfig, rt: RuntimeConfig, tables, positions, mask,
             fs=None, max_new=None):
    """``lattice_ops.advance_frame`` onto ``tables``: (the new tables,
    FrameStructures, DistributeOut)."""
    return lo.advance_frame(tables, positions, mask, rt.sigma,
                            subtract_local_mean(cfg), fs, max_new)


class StreamGraphs(_GraphCache):
    """The plain stream's frames as CUDA graphs (:class:`_GraphCache`): the
    frame distributed onto the state's tables with every level's structures
    built (:func:`_advance`), then the model on them.

    A frame's key: first frame or not, early return or final, the shapes
    and dtypes of the frame and of the fusion states, the fusion sites'
    prev_counts that are still Python numbers, and the pointnet max's
    route.  The model's output (out, new state, aux) comes back, aux None
    on a non-final frame."""

    unit = "frame"

    def __init__(self, model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig):
        super().__init__(model)
        self.cfg, self.rt = cfg, rt

    def key(self, p, v, m, state: SeqState, final: bool):
        return (state.t == 0, final,
                tuple((x.shape, x.dtype) for x in (p, v, m, *state.h)),
                tuple(None if isinstance(c, torch.Tensor) else c
                      for c in state.prev_counts),
                segment.packed_route())

    def parts(self, p, v, m, state: SeqState, final: bool):
        t = state.t

        def lattice(p, m, tables):
            return _advance(self.cfg, self.rt, tables, p, m)

        def network(structures, v, h, prev_counts):
            tables, fs, dist = structures
            out, new, aux = self.model(
                SeqState(h=h, prev_counts=prev_counts, t=t, tables=tables),
                fs, dist, values=v, final=final)
            return out, new, aux if final else None

        return (lattice, network, (p, m, state.tables),
                (v, state.h, state.prev_counts))

    def __call__(self, name: str, args: tuple, **ids):
        out, new, aux = super().__call__(name, args, **ids)
        # a replayed frame's state holds the captured frame's t
        return out, dataclasses.replace(new, t=args[3].t + 1), aux


def make_streaming_inference(model: LNNSeq, cfg: ModelConfig,
                             rt: RuntimeConfig):
    """Online (frame-at-a-time) inference: every frame is distributed onto
    the carried vertex tables and builds every level's neighbor table and
    coarse link in full, then runs the network on those structures.  On the
    card a frame is served by replaying the CUDA graphs of its key
    (:class:`StreamGraphs`).

    Returns ``(new_state_fn, step_fn, final_fn)``:
      new_state_fn()                        -> fresh SeqState with tables
      step_fn(pos, vals, mask, state)       -> state (early return)
      final_fn(pos, vals, mask, state)      -> (logp, logits, state, aux)
    Frames are (P, 3), (P, V), (P,), numpy arrays or tensors; they move to
    the model's device.  Every tensor returned is fresh: a later call
    changes none.  ``step_fn.graphs`` (also ``final_fn.graphs``) is the
    :class:`StreamGraphs`, with its counters.
    """
    dev = model.device
    cache = StreamGraphs(model, cfg, rt)

    def new_state_fn():
        return init_state(cfg, rt, dev, tables=True)

    @torch.no_grad()
    def step_fn(positions, values, mask, state):
        p, v, m = _frame_inputs(dev, positions, values, mask)
        _, state, _ = cache("tln.engine.stream_step",
                            (p, v, m, state, False), frame=state.t)
        return state

    @torch.no_grad()
    def final_fn(positions, values, mask, state):
        p, v, m = _frame_inputs(dev, positions, values, mask)
        (logp, sv), state, aux = cache("tln.engine.stream_final",
                                       (p, v, m, state, True), frame=state.t)
        return logp, sv, state, aux

    step_fn.graphs = final_fn.graphs = cache
    return new_state_fn, step_fn, final_fn


def make_streaming_inference_incremental(model: LNNSeq, cfg: ModelConfig,
                                         rt: RuntimeConfig,
                                         max_new: int = 8192):
    """Streaming inference with incremental structure updates, the fast
    serving path: after the first frame only the at most ``max_new`` new
    vertices of each level get neighbor-table rows and link rows
    (``lattice_ops.update_neighbor_table``,
    ``grow_coarse_table_incremental``), patched into the carried
    structures.  A frame that adds more sets the sticky
    ``FrameStructures.overflowed``.

    Returns ``(new_fn, step_full, step_inc, final_inc)``; the caller picks
    the branch (``step_full`` for the first frame, whose growth exceeds the
    bound, ``step_inc`` afterwards):
      new_fn()                              -> (SeqState, FrameStructures)
      step_*(pos, vals, mask, state, fs)    -> (state, fs)
      final_inc(pos, vals, mask, state, fs) -> (logp, logits, state, fs, aux)
    """
    dev = model.device
    L = cfg.nr_downsamples
    caps = rt.capacities(L)

    def new_fn():
        fs = lo.FrameStructures(
            nbrs=tuple(lo.NeighborTable(
                idx=torch.zeros((c, 9), dtype=torch.int64, device=dev),
                found=torch.zeros((c, 9), dtype=torch.bool, device=dev))
                for c in caps),
            links=tuple(lo.LevelLink(
                corner_idx=torch.zeros((caps[i], 4), dtype=torch.int64,
                                       device=dev),
                corner_bary=torch.zeros((caps[i], 4), device=dev))
                for i in range(L)),
            counts=tuple(torch.ones((), dtype=torch.int64, device=dev)
                         for _ in caps),
            overflowed=torch.zeros((), dtype=torch.bool, device=dev))
        return init_state(cfg, rt, dev, tables=True), fs

    def make_step(incremental: bool, final: bool):
        name = "tln.engine.stream_final" if final \
            else "tln.engine.stream_step"

        @torch.no_grad()
        def fn(positions, values, mask, state, fs):
            with span(name, unit=next(_UNITS), frame=state.t):
                p, v, m = _frame_inputs(dev, positions, values, mask)
                with span("tln.lattice.frame", frame=state.t):
                    tables, fs, dist = _advance(
                        cfg, rt, state.tables, p, m, fs,
                        max_new if incremental else None)
                out, state, aux = model(
                    dataclasses.replace(state, tables=tables), fs, dist,
                    values=v, final=final)
            if final:
                return out[0], out[1], state, fs, aux
            return state, fs
        return fn

    return new_fn, make_step(False, False), make_step(True, False), \
        make_step(True, True)


def make_streaming_inference_batched(model: LNNSeq, cfg: ModelConfig,
                                     rt: RuntimeConfig, mesh=None,
                                     incremental: bool = False,
                                     max_new: int = 8192):
    """B concurrent streams, each with its own state (and, with
    ``incremental``, its own ``FrameStructures``), stepped in turn on the
    model's device; per-stream outputs equal the single-stream path's.

    Returns ``(new_states_fn, step_fn, final_fn)``, with ``incremental``
    ``(new_states_fn, step_full_fn, step_fn, final_fn)``:
      new_states_fn(B)                           -> carry (a list of states)
      step_fn(pos (B,P,3), vals (B,P,V), mask (B,P), carry) -> carry
      final_fn(...)  -> (logp (B,P,K), logits (B,P,K), carry, aux stacked)

    With a ``parallel.mesh.Mesh`` the streams are split over its ranks: the
    inputs stay the global (B, ...) arrays (B a multiple of the world size),
    rank r keeps and steps only streams ``[r*B/R, (r+1)*B/R)`` with no
    collective (the streams are independent), and ``final_fn`` gathers the
    log-probabilities, logits and aux of every stream onto every rank.
    """
    if mesh is not None and not isinstance(mesh, pmesh.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    world, rank = (mesh.world_size, mesh.rank) if mesh is not None \
        else (1, 0)
    # each stream's carry as the single-stream functions take it, unpacked
    if incremental:
        new1, full1, step1, final1 = make_streaming_inference_incremental(
            model, cfg, rt, max_new)
        args, carry_of = (lambda c: c), (lambda out: out[2:4])
    else:
        new1, step1, final1 = make_streaming_inference(model, cfg, rt)
        args, carry_of = (lambda c: (c,)), (lambda out: out[2])

    def new_states_fn(b: int):
        if b % world:
            raise ValueError(f"{b} streams do not split over {world} ranks")
        return [new1() for _ in range(b // world)]

    def own(carry):
        """The global indices of this rank's streams."""
        return range(rank * len(carry), (rank + 1) * len(carry))

    def stepper(fn):
        def step_fn(positions, values, mask, carry):
            return [fn(positions[i], values[i], mask[i], *args(c))
                    for i, c in zip(own(carry), carry)]
        return step_fn

    def final_fn(positions, values, mask, carry):
        outs = [final1(positions[i], values[i], mask[i], *args(c))
                for i, c in zip(own(carry), carry)]
        stacked = [torch.stack([o[0] for o in outs]),
                   torch.stack([o[1] for o in outs])]
        aux = {k: torch.stack([torch.as_tensor(o[-1][k]) for o in outs])
               for k in outs[0][-1]}
        if mesh is not None:
            stacked = [pmesh.all_gather(mesh, t) for t in stacked]
            aux = {k: pmesh.all_gather(mesh, v) for k, v in aux.items()}
        return stacked[0], stacked[1], [carry_of(o) for o in outs], aux

    if incremental:
        return new_states_fn, stepper(full1), stepper(step1), final_fn
    return new_states_fn, stepper(step1), final_fn


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class SeqBatch(NamedTuple):
    """A batch of padded sequences, shapes (B, T, P, ...); numpy arrays or
    tensors."""

    positions: Any
    values: Any
    labels: Any
    mask: Any

    @staticmethod
    def stack(frame_lists, device=None) -> "SeqBatch":
        """frame_lists: a list over the batch of lists over time of
        ``FrameBatch``; the tensors are made on ``device`` (CUDA by
        default), from pinned host memory without a host sync on CUDA."""
        dev = resolve_device(device)

        def take(attr):
            a = torch.from_numpy(np.stack(
                [np.stack([getattr(f, attr) for f in seq])
                 for seq in frame_lists]))
            if dev.type == "cuda":
                return a.pin_memory().to(dev, non_blocking=True)
            return a
        return SeqBatch(take("positions"), take("values"), take("labels"),
                        take("mask"))


@dataclasses.dataclass
class TrainState:
    """The optimizer over the model's parameters and the step count."""

    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg: ModelConfig, rt: RuntimeConfig, lr: float,
                       weight_decay: float, seed: int = 0, device=None,
                       n_values: int = 1):
    """The model (parameters from ``torch.Generator(seed)``, on ``device``,
    CUDA by default) and its AdamW(amsgrad) train state.  Returns
    ``(model, state)``."""
    model = LNNSeq(cfg, rt, device=device, seed=seed, n_values=n_values)
    return model, TrainState(optim.make_optimizer(model.parameters(), lr,
                                                  weight_decay))


def _batch_metrics(outs):
    """A batch's metrics and its stacked logp from each sequence's (loss,
    logp, loss parts, aux)."""
    def mean(xs):
        return torch.stack([x.detach() for x in xs]).mean()
    m = {"loss": mean([o[0] for o in outs]),
         "lovasz": mean([o[2]["lovasz"] for o in outs]),
         "nll": mean([o[2]["nll"] for o in outs]),
         "nr_vertices": torch.stack(
             [o[3]["nr_vertices"] for o in outs]).max(),
         "vertex_overflow": torch.stack(
             [o[3]["vertex_overflow"] for o in outs]).any()}
    if "dropped_share" in outs[0][3]:
        m["dropped_share"] = mean([o[3]["dropped_share"] for o in outs])
    return m, torch.stack([o[1].detach() for o in outs])


def _zero_unreached(params: dict) -> None:
    """A zero gradient for each parameter the loss does not reach, so that
    AdamW still decays it, as the optax chain does."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _grad_norms(params: dict, watch_grads: bool) -> dict:
    """``grad_norm``, the global norm of the gradients, and with
    ``watch_grads`` ``grad_norms``, {parameter name: its gradient's
    norm}."""
    gsq = torch.stack([(p.grad.float() ** 2).sum() for p in params.values()])
    m = {"grad_norm": torch.sqrt(gsq.sum())}
    if watch_grads:
        m["grad_norms"] = dict(zip(params, torch.sqrt(gsq)))
    return m


class StepGraphs(_GraphCache):
    """The training step's gradients as CUDA graphs (:class:`_GraphCache`):
    the sequence lattice of each sequence of the batch
    (:func:`_sequence_parts`), then, one sequence at a time, the network
    under the run's remat, the loss of its last frame and ``.backward()``
    (of the loss over B), a zero gradient for each parameter the loss does
    not reach, the batch's metrics and the gradient norms.  The unit
    returns (metrics, logp, gradients); AdamW runs after it, eagerly
    (:func:`make_train_step`).  Capture leaves the captured gradients in
    ``.grad``, so the step binds each parameter's ``.grad`` to the unit's
    gradients before AdamW reads them: the warm-up's own, or a replay's.

    Replays only where the whole step can be captured: on the card, with
    gradients on, outside ``LNNSeq.sow_aux``, without a mesh (the
    all-reduce stays eager) and without dropout (a step's generator cannot
    be baked into a graph).  A step's key: the shapes and dtypes of its
    positions, values, labels and mask (the batch size among them), the
    pointnet max's route, the remat mode and ``watch_grads``."""

    unit = "step"

    def __init__(self, model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                 remat: str, ignore_index: int, watch_grads: bool,
                 mesh=None):
        super().__init__(model)
        self.lattice, self.network = _sequence_parts(model, cfg, rt, remat)
        self.remat, self.watch_grads = remat, watch_grads
        self.ignore_index = ignore_index
        self.whole = mesh is None and cfg.dropout_last_layer == 0
        self.params = dict(model.named_parameters())

    def replayable(self) -> bool:
        return (self.card and self.whole and torch.is_grad_enabled()
                and not self.model.sowing)

    def key(self, p, v, labels, m):
        return (tuple((x.shape, x.dtype) for x in (p, v, labels, m)),
                segment.packed_route(), self.remat, self.watch_grads)

    def parts(self, p, v, labels, m):
        return (self.lattices, self.gradients, (p, v, m),
                (v, labels[:, -1], m[:, -1]))

    def lattices(self, p, v, m):
        return tuple(self.lattice(p[i], v[i], m[i])
                     for i in range(p.shape[0]))

    def gradients(self, structures, v, labels, mask):
        for p in self.params.values():
            p.grad = None
        b = len(structures)
        outs = []
        for i, st in enumerate(structures):
            with span("tln.train.forward"):
                logp, _, aux = self.network(st, v[i], None)
            with span("tln.train.loss"):
                loss, parts = segmentation_loss(logp, labels[i], mask[i],
                                                self.ignore_index)
            with span("tln.train.backward"):
                (loss / b).backward()
            outs.append((loss, logp, parts, aux))
        _zero_unreached(self.params)
        with span("tln.train.loss"):
            metrics, logp = _batch_metrics(outs)
        metrics.update(_grad_norms(self.params, self.watch_grads))
        return metrics, logp, tuple(p.grad for p in self.params.values())


def make_train_step(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                    ignore_index: int = 0, watch_grads: bool = False,
                    mesh=None):
    """The training and evaluation steps of one model.

    ``train_step(state, batch, lr_scale) -> (state, logp (B, P, classes),
    metrics)``: the loss of a batch of B sequences is the mean of their last
    frames' losses (0.5 Lovász + 0.5 NLL), its gradient runs through every
    frame, and one AdamW step at ``lr * lr_scale`` follows.  The gradient
    is computed one sequence at a time (``backward`` of each loss over B,
    summed by autograd in ``.grad``), so the peak memory is one sequence's.
    Metrics (0-d tensors on the device): loss, lovasz and nll (means over
    the batch), grad_norm (the global norm of the summed gradient),
    nr_vertices (the largest) and vertex_overflow (any); with
    ``watch_grads`` also grad_norms, {parameter name: its gradient's norm}
    (what ``wandb.watch`` tracks in the reference); with dropout
    (``dropout_last_layer > 0``) also dropped_share, the mean share of the
    final frames' slice features dropped.  Sequence ``i`` of the batch
    draws its dropout mask from ``dropout_generator(device, step, i)``.
    ``eval_step(batch) -> (logp, metrics)`` runs without gradients, and so
    does ``train_step.loss_step(batch)``, the forward and loss alone; both
    run without dropout.  ``train_step.grad_step(batch, step=0) -> (loss,
    {name: grad})`` returns the gradients of the training step ``step``
    (its dropout masks) without an optimizer step.  The rematerialisation
    is ``rt.remat_mode``.

    On the card, without a mesh and without dropout, ``train_step`` serves
    its gradients by replaying the CUDA graphs of the batch's key
    (:class:`StepGraphs`, ``train_step.graphs``) and runs AdamW eagerly
    after them, so that a learning-rate scale set each step is read as it
    is; every other step, and ``grad_step``, ``loss_step`` and
    ``eval_step``, run eagerly.

    With a ``parallel.mesh.Mesh``, each rank passes its own ``B / R``
    sequences of the global batch (``mesh.shard_batch``): ``train_step`` and
    ``grad_step`` average the ranks' gradients in one all-reduce before the
    optimizer step and reduce the metrics to the global batch's, so that R
    ranks take the step one process takes with the whole batch, and every
    rank keeps the same weights.  ``logp`` is the rank's own sequences';
    ``eval_step`` and ``loss_step`` run on the rank's batch alone.
    """
    if mesh is not None and not isinstance(mesh, pmesh.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    remat = rt.remat_mode or "full"
    seq_fwd = sequence_forward(model, cfg, rt, remat=remat)
    steps = StepGraphs(model, cfg, rt, remat, ignore_index, watch_grads,
                       mesh)
    dev = model.device
    params = dict(model.named_parameters())
    rank = mesh.rank if mesh is not None else 0

    def loss_one(batch: SeqBatch, i: int, gen=None):
        """The loss of sequence ``i`` of the batch, with the slice head's
        dropout drawn from ``gen`` (None: no dropout)."""
        with span("tln.train.forward"):
            logp, _, aux = seq_fwd(batch.positions[i], batch.values[i],
                                   batch.mask[i], gen)
        with span("tln.train.loss"):
            labels = torch.as_tensor(batch.labels[i][-1], device=dev)
            mask = torch.as_tensor(batch.mask[i][-1], device=dev)
            loss, parts = segmentation_loss(logp, labels, mask, ignore_index)
        return loss, logp, parts, aux

    def reduce_metrics(m):
        """The rank's metrics -> the global batch's (means averaged over the
        ranks, which hold equal shares; the rest their maxima)."""
        means = [k for k in ("loss", "lovasz", "nll", "dropped_share")
                 if k in m]
        vals = [m[k].clone() for k in means]
        pmesh.all_reduce_mean(mesh, vals)
        m.update(zip(means, vals))
        for k in ("nr_vertices", "vertex_overflow"):
            m[k] = pmesh.all_reduce_max(mesh, m[k])
        return m

    def gradients(batch: SeqBatch, step: int):
        for p in params.values():
            p.grad = None
        b = batch.positions.shape[0]
        drop = cfg.dropout_last_layer > 0
        outs = []
        for i in range(b):
            gen = dropout_generator(dev, step, rank * b + i) if drop else None
            out = loss_one(batch, i, gen)
            with span("tln.train.backward"):
                (out[0] / b).backward()
            outs.append(out)
        _zero_unreached(params)
        with span("tln.train.loss"):
            metrics, logp = _batch_metrics(outs)
        if mesh is not None:
            pmesh.all_reduce_mean(mesh, [p.grad for p in params.values()])
            metrics = reduce_metrics(metrics)
        return metrics, logp

    def optimizer_step(state: TrainState, lr_scale):
        optim.set_lr_scale(state.optimizer, lr_scale)
        state.optimizer.step()

    def train_step(state: TrainState, batch: SeqBatch, lr_scale):
        if steps.replayable():
            def bind_and_step(out):
                metrics, logp, grads = out
                for p, g in zip(params.values(), grads, strict=True):
                    p.grad = g
                with span("tln.train.optimizer"):
                    optimizer_step(state, lr_scale)
                return metrics, logp
            metrics, logp = steps(
                "tln.engine.train_step",
                tuple(torch.as_tensor(a, device=dev) for a in batch),
                then=bind_and_step)
        else:
            steps.counts["eager"] += 1
            with span("tln.engine.train_step", unit=next(_UNITS), graph=0):
                metrics, logp = gradients(batch, state.step)
                with span("tln.train.optimizer"):
                    metrics.update(_grad_norms(params, watch_grads))
                    optimizer_step(state, lr_scale)
        state.step += 1
        return state, logp, metrics

    def without_dropout(batch: SeqBatch):
        return _batch_metrics([loss_one(batch, i)
                               for i in range(batch.positions.shape[0])])

    @torch.no_grad()
    def loss_step(batch: SeqBatch):
        metrics, logp = without_dropout(batch)
        return logp, metrics

    def grad_step(batch: SeqBatch, step: int = 0):
        with span("tln.engine.train_step", unit=next(_UNITS)):
            metrics, _ = gradients(batch, step)
        return metrics["loss"], {k: p.grad for k, p in params.items()}

    @torch.no_grad()
    def eval_step(batch: SeqBatch):
        metrics, logp = without_dropout(batch)
        return logp, {k: metrics[k] for k in ("loss", "nr_vertices",
                                              "vertex_overflow")}

    train_step.loss_step = loss_step
    train_step.grad_step = grad_step
    train_step.graphs = steps
    return train_step, eval_step
