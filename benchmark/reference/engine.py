"""The reference's entries: the offline sequence forward (the port's
``train/engine.sequence_forward`` without rematerialisation, trims or
dropout, over a lattice built again from the points) and the training
steps (0.5 Lovasz + 0.5 NLL on the last frame, AdamW(amsgrad) with
decoupled weight decay)."""

from __future__ import annotations

import torch

from .config import ModelConfig, RuntimeConfig
from .models.lnn_seq import LNNSeq, init_state
from .models.losses import segmentation_loss
from .ops import seq_lattice as sl


def build_model(cfg: ModelConfig, rt: RuntimeConfig, state_dict,
                device) -> LNNSeq:
    """The reference model on ``device`` with the benchmark's weights."""
    model = LNNSeq(cfg, rt, device=device)
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           for k, v in state_dict.items()}, strict=True)
    return model


def sequence_lattice(cfg: ModelConfig, rt: RuntimeConfig, positions, mask):
    """The whole sequence's lattice at the full capacities (no trims)."""
    L = cfg.nr_downsamples
    return sl.build_sequence_lattice(positions, mask, rt.sigma,
                                     rt.capacities(L), L)


def level_counts(cfg: ModelConfig, rt: RuntimeConfig, positions, mask):
    """(T, L + 1) vertex counts of each frame's lattice (row 0, the invalid
    vertex, included) and (T,) valid points: what the FLOP count reads."""
    with torch.no_grad():
        lat = sequence_lattice(cfg, rt, positions, mask)
    counts = torch.stack([lv.counts for lv in lat.levels], dim=1)
    return counts.cpu(), mask.sum(dim=1).cpu()


def forward(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig, positions,
            values, mask):
    """The last frame's (logp (P, classes), logits, aux) of one sequence
    (positions (T, P, 3), values (T, P, V), mask (T, P))."""
    state = init_state(cfg, rt, model.device)
    t = positions.shape[0]
    with torch.no_grad():
        seqlat = sequence_lattice(cfg, rt, positions, mask)
    dist = seqlat.distribute_out()
    for f in range(t - 1):
        _, state, _ = model(state, seqlat, dist.frame(f), final=False,
                            values=values[f])
    (logp, sv), state, aux = model(state, seqlat, dist.frame(t - 1),
                                   final=True, values=values[-1])
    return logp, sv, aux


def make_optimizer(model: LNNSeq, lr: float, weight_decay: float):
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay,
                             amsgrad=True)


def train_steps(model: LNNSeq, cfg: ModelConfig, rt: RuntimeConfig, windows,
                lr: float, weight_decay: float, ignore_index: int = 0):
    """One AdamW(amsgrad) step on each window (positions, values, labels,
    mask) in turn.  Returns (each step's loss, the first step's gradient
    {name: tensor}, the parameters after the last step {name: tensor}, the
    first step's log-probabilities)."""
    opt = make_optimizer(model, lr, weight_decay)
    params = dict(model.named_parameters())
    losses, first_grad, first_logp = [], None, None
    for positions, values, labels, mask in windows:
        opt.zero_grad(set_to_none=True)
        logp, _, _ = forward(model, cfg, rt, positions, values, mask)
        loss, _ = segmentation_loss(logp, labels[-1], mask[-1], ignore_index)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if first_grad is None:
            first_grad = {k: p.grad.detach().clone()
                          for k, p in params.items()}
            first_logp = logp.detach()
        opt.step()
        losses.append(float(loss.detach()))
        del logp, loss
    return losses, first_grad, {k: p.detach().clone()
                                for k, p in params.items()}, first_logp
