"""Optimiser and learning-rate schedules of the training recipe (port of the
JAX package's ``train/optim.py``): AdamW with amsgrad and decoupled weight
decay, a per-step learning-rate scale set from the host, and the
CosineAnnealingWarmRestarts / ReduceLROnPlateau scales.

The JAX package builds the amsgrad rule as an optax chain (moments,
``v_hat = max(v_hat, v)``, bias corrections, then ``+ weight_decay * p`` and
``* -lr * lr_scale``); that is ``torch.optim.AdamW(amsgrad=True)`` step for
step, with ``lr * lr_scale`` as each parameter group's learning rate.
"""

from __future__ import annotations

import math

import torch


def make_optimizer(params, lr: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """AdamW(amsgrad) with decoupled weight decay.  Each parameter group
    keeps its base rate under ``"base_lr"``; :func:`set_lr_scale` sets the
    step's rate to ``base_lr * lr_scale``."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, amsgrad=True)
    for group in opt.param_groups:
        group["base_lr"] = lr
    return opt


def set_lr_scale(opt: torch.optim.Optimizer, lr_scale: float) -> None:
    """The JAX package's injected ``lr_scale`` hyperparameter."""
    for group in opt.param_groups:
        group["lr"] = group["base_lr"] * float(lr_scale)


def cosine_warm_restarts(epoch_frac: float, t0: float,
                         eta_min: float = 0.0) -> float:
    """torch CosineAnnealingWarmRestarts(T_0) stepped with a fractional
    epoch: a multiplicative scale in (0, 1]."""
    t_cur = math.fmod(epoch_frac, t0)
    return eta_min + (1.0 - eta_min) * (1 + math.cos(math.pi * t_cur / t0)) / 2


class ReduceLROnPlateau:
    """Host-side mirror of torch's ReduceLROnPlateau(patience=10,
    factor=0.1) as a learning-rate scale."""

    def __init__(self, patience: int = 10, factor: float = 0.1,
                 min_scale: float = 1e-8):
        self.patience = patience
        self.factor = factor
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale
