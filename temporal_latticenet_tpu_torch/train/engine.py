"""Offline sequence forward and the BPTT training step (port of the JAX
package's ``train/engine.py``: ``make_sequence_forward(precompute=True)``,
``create_train_state`` and ``make_train_step``).

The whole sequence's lattice is built in one birth-tagged pass
(``ops/seq_lattice``), the pointnet MLP + max runs once for all frames over
the union-sorted rows, frames 0..T-2 run the trimmed early-return network on
row prefixes of the lattice (a Python loop in place of ``lax.scan``), and
the final frame runs the full model on its own trimmed view.  The training
step differentiates that forward end to end (backpropagation through time
over the carried fusion states) under the loss of ``models/losses.py`` and
takes one AdamW(amsgrad) step.  The streaming per-frame path
(``precompute=False``), batches of more than one sequence and dropout are
not ported.
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
    """The inference entry point: :func:`sequence_forward` with gradients
    off.  Single sequence: (positions (T,P,3), values (T,P,V), mask (T,P))
    -> (logp (P, classes), logits, aux) for the last frame."""
    if not precompute:
        raise NotImplementedError(
            "the streaming per-frame path is not ported to PyTorch yet")
    fwd = sequence_forward(model, cfg, rt, remat="none")

    @torch.no_grad()
    def seq_forward(positions, values, mask):
        return fwd(positions, values, mask)

    return seq_forward


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
