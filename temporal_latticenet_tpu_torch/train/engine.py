"""Sequence forwards, streaming inference and the BPTT training step (port
of the JAX package's ``train/engine.py``: ``make_sequence_forward``,
``make_streaming_inference`` and its incremental and batched forms,
``create_train_state`` and ``make_train_step``).

The whole sequence's lattice is built in one birth-tagged pass
(``ops/seq_lattice``), the pointnet MLP + max runs once for all frames over
the union-sorted rows, frames 0..T-2 run the trimmed early-return network on
row prefixes of the lattice (a Python loop in place of ``lax.scan``), and
the final frame runs the full model on its own trimmed view.  The training
step differentiates that forward end to end (backpropagation through time
over the carried fusion states) under the loss of ``models/losses.py`` and
takes one AdamW(amsgrad) step.  Batches of more than one sequence and
dropout are not ported.

Streaming inference serves one scan at a time, as a deployed system does:
the vertex tables and fusion states carry over between frames, and each
frame is distributed onto the tables (kernel K1) and runs the network on
per-frame structures, built in full every frame or, on the incremental
path, updated for the new vertices only.  Its steps keep every count on the
device: no step reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, RuntimeConfig
from ..models.lnn_seq import SITES, LNNSeq, init_state, site_level
from ..models.losses import segmentation_loss
from ..ops import lattice_ops as lo
from ..ops import seq_lattice as sl
from . import optim

REMAT_MODES = ("none", "selective", "full")


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


def sequence_forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                     remat: str = "none"):
    """Single-sequence forward with gradients: (positions (T,P,3), values
    (T,P,V), mask (T,P)) -> (logp (P, classes), logits, aux) for the last
    frame.

    ``remat`` sets what the backward recomputes instead of keeping:
      "none"      -- keep every activation;
      "selective" -- keep everything except each lattice convolution's
                     (C, 9*Cin) rowified rows (``lattice_ops.remat_conv_rows``);
      "full"      -- keep only each frame's inputs and recompute the frame.

    Inputs may be numpy arrays or tensors; they move to the model's device.
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    if not (rt.batched_pointnet and cfg.experiment == "none"
            and cfg.compute_dtype == "bfloat16"):
        raise NotImplementedError(
            "only the batched pointnet path (bf16, experiment 'none') is "
            "ported to PyTorch yet")
    L = cfg.nr_downsamples
    dev = model.device
    frame = _remat_frame(model, remat)

    def site_caps(which):
        return [which[site_level(cfg, s)] for s in SITES]

    def seq_forward(positions, values, mask):
        positions = torch.as_tensor(positions, device=dev)
        values = torch.as_tensor(values, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        state = init_state(cfg, rt, dev)
        t = positions.shape[0]
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

        full_dist = lo.DistributeOut(
            row_vertex=seqlat.row_vertex, row_bary=seqlat.row_bary,
            row_rel_pos=seqlat.row_rel_pos, row_valid=seqlat.row_valid,
            point_vertex=seqlat.point_vertex, point_bary=seqlat.point_bary)
        with lo.remat_conv_rows(remat == "selective"):
            reduced_all = model.reduce_pointnet(seqlat, values)

            if t > 1:
                if trim_caps is not None:
                    with torch.no_grad():
                        scan_lat = sl.trim_sequence_lattice(seqlat, trim_caps)
                    red_scan = reduced_all[:-1, : trim_caps[0]]
                    state.h = tuple(
                        a[:c] if a.shape[0] > 1 else a
                        for a, c in zip(state.h, site_caps(trim_caps)))
                else:
                    scan_lat, red_scan = seqlat, reduced_all[:-1]
                for f in range(t - 1):
                    _, state, _ = frame(state, scan_lat, full_dist.frame(f),
                                        red_scan[f], final=False)
            if trim_caps is not None or final_caps is not None:
                target = site_caps(final_caps if final_caps is not None
                                   else rt.capacities(L))
                state.h = tuple(_resize_rows(a, c) if a.shape[0] > 1 else a
                                for a, c in zip(state.h, target))
            if final_caps is not None:
                with torch.no_grad():
                    final_lat = sl.trim_sequence_lattice(seqlat, final_caps)
                red_final = reduced_all[-1, : final_caps[0]]
            else:
                final_lat, red_final = seqlat, reduced_all[-1]
            (logp, sv), state, aux = frame(state, final_lat,
                                           full_dist.frame(t - 1), red_final,
                                           final=True)
        aux["trim_overflow"] = trim_overflow
        aux["vertex_overflow"] = aux["vertex_overflow"] | trim_overflow
        return logp, sv, aux

    return seq_forward


def make_sequence_forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                          precompute: bool = True):
    """The inference entry point, with gradients off.  Single sequence:
    (positions (T,P,3), values (T,P,V), mask (T,P)) -> (logp (P, classes),
    logits, aux) for the last frame.  ``precompute=True`` is
    :func:`sequence_forward` over the whole-sequence lattice;
    ``precompute=False`` steps :func:`make_streaming_inference` through the
    frames."""
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
    fwd = sequence_forward(model, cfg, rt, remat="none")

    @torch.no_grad()
    def seq_forward(positions, values, mask):
        return fwd(positions, values, mask)

    return seq_forward


# ---------------------------------------------------------------------------
# streaming inference
# ---------------------------------------------------------------------------

def _check_streaming(cfg: ModelConfig):
    if cfg.experiment != "none" or cfg.compute_dtype != "bfloat16":
        raise NotImplementedError(
            "streaming inference is ported for experiment 'none' in bf16 "
            "only (the per-frame pointnet)")


def _frame_inputs(dev, positions, values, mask):
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (positions, values, mask))


def make_streaming_inference(model: LNNSeq, cfg: ModelConfig,
                             rt: RuntimeConfig):
    """Online (frame-at-a-time) inference: every frame is distributed onto
    the carried vertex tables and builds every level's neighbor table and
    coarse link in full.

    Returns ``(new_state_fn, step_fn, final_fn)``:
      new_state_fn()                        -> fresh SeqState with tables
      step_fn(pos, vals, mask, state)       -> state (early return)
      final_fn(pos, vals, mask, state)      -> (logp, logits, state, aux)
    Frames are (P, 3), (P, V), (P,), numpy arrays or tensors; they move to
    the model's device.
    """
    _check_streaming(cfg)
    dev = model.device

    def new_state_fn():
        return init_state(cfg, rt, dev, tables=True)

    @torch.no_grad()
    def step_fn(positions, values, mask, state):
        p, v, m = _frame_inputs(dev, positions, values, mask)
        _, state, _ = model(state, positions=p, values=v, mask=m,
                            final=False)
        return state

    @torch.no_grad()
    def final_fn(positions, values, mask, state):
        p, v, m = _frame_inputs(dev, positions, values, mask)
        (logp, sv), state, aux = model(state, positions=p, values=v, mask=m,
                                       final=True)
        return logp, sv, state, aux

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
    _check_streaming(cfg)
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

    def advance(state, positions, mask, fs, incremental: bool):
        """Distribute the frame, then build (full) or patch (incremental)
        every level's structures."""
        old = [tb.count for tb in state.tables]
        t0, dist = lo.distribute(state.tables[0], positions, mask, rt.sigma)
        tabs = [t0]
        if not incremental:
            nbrs, links = [lo.build_neighbor_table(t0)], []
            for i in range(L):
                c, link = lo.grow_coarse_table(tabs[i], state.tables[i + 1])
                tabs.append(c)
                links.append(link)
                nbrs.append(lo.build_neighbor_table(c))
            overflowed = fs.overflowed
        else:
            nbrs, links = list(fs.nbrs), list(fs.links)
            nbrs[0] = lo.update_neighbor_table(t0, nbrs[0], old[0], max_new)
            for i in range(L):
                c, links[i] = lo.grow_coarse_table_incremental(
                    tabs[i], state.tables[i + 1], old[i], links[i], max_new)
                tabs.append(c)
                nbrs[i + 1] = lo.update_neighbor_table(c, nbrs[i + 1],
                                                       old[i + 1], max_new)
            grew = torch.stack([tb.count - o for tb, o in zip(tabs, old)])
            overflowed = fs.overflowed | (grew > max_new).any()
        fs = lo.FrameStructures(nbrs=tuple(nbrs), links=tuple(links),
                                counts=tuple(tb.count for tb in tabs),
                                overflowed=overflowed)
        return dataclasses.replace(state, tables=tuple(tabs)), fs, dist

    def make_step(incremental: bool, final: bool):
        @torch.no_grad()
        def fn(positions, values, mask, state, fs):
            p, v, m = _frame_inputs(dev, positions, values, mask)
            state, fs, dist = advance(state, p, m, fs, incremental)
            out, state, aux = model(state, fs, dist, values=v, final=final)
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
      new_states_fn(B)                           -> carry (a list of B states)
      step_fn(pos (B,P,3), vals (B,P,V), mask (B,P), carry) -> carry
      final_fn(...)  -> (logp (B,P,K), logits (B,P,K), carry, aux stacked)
    A ``mesh`` (the JAX package's sharding of the streams over devices) is
    not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharding the streams over a device mesh is not ported to "
            "PyTorch yet")
    # each stream's carry as the single-stream functions take it, unpacked
    if incremental:
        new1, full1, step1, final1 = make_streaming_inference_incremental(
            model, cfg, rt, max_new)
        args, carry_of = (lambda c: c), (lambda out: out[2:4])
    else:
        new1, step1, final1 = make_streaming_inference(model, cfg, rt)
        args, carry_of = (lambda c: (c,)), (lambda out: out[2])

    def new_states_fn(b: int):
        return [new1() for _ in range(b)]

    def stepper(fn):
        def step_fn(positions, values, mask, carry):
            return [fn(positions[i], values[i], mask[i], *args(c))
                    for i, c in enumerate(carry)]
        return step_fn

    def final_fn(positions, values, mask, carry):
        outs = [final1(positions[i], values[i], mask[i], *args(c))
                for i, c in enumerate(carry)]
        aux = {k: torch.stack([torch.as_tensor(o[-1][k]) for o in outs])
               for k in outs[0][-1]}
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                [carry_of(o) for o in outs], aux)

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


def make_train_step(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig,
                    ignore_index: int = 0):
    """The training and evaluation steps of one model.

    ``train_step(state, batch, lr_scale) -> (state, logp (1, P, classes),
    metrics)``: the loss of the last frame (0.5 Lovász + 0.5 NLL), its
    gradient through every frame, and one AdamW step at ``lr * lr_scale``.
    Metrics (0-d tensors on the device): loss, lovasz, nll, grad_norm (the
    global norm of the gradients), nr_vertices and vertex_overflow.
    ``eval_step(batch) -> (logp, metrics)`` runs without gradients, and so
    does ``train_step.loss_step(batch)``, the forward and loss alone;
    ``train_step.grad_step(batch) -> (loss, {name: grad})`` returns
    the gradients without an optimizer step.  The rematerialisation is
    ``rt.remat_mode``.  Batches hold one sequence.
    """
    if cfg.dropout_last_layer > 0:
        raise NotImplementedError(
            "dropout in the deform-slice head is not ported to PyTorch yet")
    seq_fwd = sequence_forward(model, cfg, rt, remat=rt.remat_mode or "full")
    dev = model.device
    params = dict(model.named_parameters())

    def loss_one(batch: SeqBatch):
        b = batch.positions.shape[0]
        if b != 1:
            raise NotImplementedError(
                f"batches of {b} sequences: only batches of one are ported "
                f"to PyTorch yet")
        logp, _, aux = seq_fwd(batch.positions[0], batch.values[0],
                               batch.mask[0])
        labels = torch.as_tensor(batch.labels[0][-1], device=dev)
        mask = torch.as_tensor(batch.mask[0][-1], device=dev)
        loss, parts = segmentation_loss(logp, labels, mask, ignore_index)
        return loss, logp, parts, aux

    def metrics_of(loss, parts, aux):
        return {"loss": loss.detach(), "lovasz": parts["lovasz"].detach(),
                "nll": parts["nll"].detach(),
                "nr_vertices": aux["nr_vertices"],
                "vertex_overflow": aux["vertex_overflow"]}

    def gradients(batch: SeqBatch):
        for p in params.values():
            p.grad = None
        loss, logp, parts, aux = loss_one(batch)
        loss.backward()
        # parameters the loss does not reach get a zero gradient, so that
        # AdamW still decays them, as the optax chain does
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss, logp, parts, aux

    def train_step(state: TrainState, batch: SeqBatch, lr_scale):
        loss, logp, parts, aux = gradients(batch)
        grad_norm = torch.sqrt(torch.stack(
            [(p.grad.float() ** 2).sum() for p in params.values()]).sum())
        optim.set_lr_scale(state.optimizer, lr_scale)
        state.optimizer.step()
        state.step += 1
        metrics = metrics_of(loss, parts, aux)
        metrics["grad_norm"] = grad_norm
        return state, logp.detach()[None], metrics

    @torch.no_grad()
    def loss_step(batch: SeqBatch):
        loss, logp, parts, aux = loss_one(batch)
        return logp[None], metrics_of(loss, parts, aux)

    def grad_step(batch: SeqBatch):
        loss, _, _, _ = gradients(batch)
        return loss.detach(), {k: p.grad for k, p in params.items()}

    @torch.no_grad()
    def eval_step(batch: SeqBatch):
        loss, logp, _, aux = loss_one(batch)
        return logp[None], {"loss": loss,
                            "nr_vertices": aux["nr_vertices"],
                            "vertex_overflow": aux["vertex_overflow"]}

    train_step.loss_step = loss_step
    train_step.grad_step = grad_step
    return train_step, eval_step
