"""Training: the port's ``make_train_step`` on the pool's labelled windows
(batch 1), one step after another, each step's loss fetched to the host.
Set-up builds the one trainer (model, AdamW(amsgrad) state) and drives it
through its first ``check_steps`` steps on distinct windows, with the same
call and feed as the window; the reference follows those steps after the
window closes.

``train_points_per_s``: the real points of every frame of every window
trained on, over the window's seconds."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function


class Loop:
    traced_units = 1
    flops_factor = 3          # a step: the forward and twice its products

    def __init__(self, ctx):
        from temporal_latticenet_tpu_torch.train import optim
        from temporal_latticenet_tpu_torch.train.engine import (
            TrainState, make_train_step)
        self.ctx = ctx
        tr = ctx.config["train"]
        self.model = ctx.port_model()
        self.model.train()
        self.state = TrainState(optim.make_optimizer(
            self.model.parameters(), tr["lr"], tr["weight_decay"]))
        self.train_step, _ = make_train_step(self.model, ctx.cfg, ctx.rt,
                                             ignore_index=tr["ignore_index"])
        self.params = dict(self.model.named_parameters())
        self.beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        self.work, self.n, self.losses = [], 0, []
        self.steps = ctx.traffic["check_steps"]

    def per(self, frames):
        return frames / self.ctx.frames          # per step

    def one(self, k):
        from temporal_latticenet_tpu_torch.train.engine import SeqBatch
        c = self.ctx
        batch = SeqBatch(c.pos[k][None], c.val[k][None], c.lab[k][None],
                         c.mask[k][None])
        with record_function("bench.train_step"):
            self.state, logp, m = self.train_step(self.state, batch, 1.0)
        if self.n == 0 and not self.losses:
            self.logp1 = logp[0].detach()
        with record_function("bench.fetch_loss"):
            loss, over = torch.stack(
                [m["loss"], m["vertex_overflow"].float()]).tolist()
        if over:
            from harness.core import RunError
            raise RunError(f"window {k} overflows a vertex table")
        return loss

    def setup(self):
        c = self.ctx
        opt = self.state.optimizer
        for i in range(self.steps):
            self.losses.append(self.one(c.order[i]))
            if i == 0:
                # the gradient as the optimizer got it (none: it took none)
                self.g1 = {n: opt.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1.0 - self.beta1)
                    for n, p in self.params.items()}
        self.theta = {n: p.detach().clone() for n, p in self.params.items()}
        self.n = self.steps

    def window(self, seconds):
        c = self.ctx
        points = 0
        self.unit_s, last = [], 0.0
        t0 = time.perf_counter()
        done = 0
        while True:
            k = c.order[self.n % c.pool_size]
            self.one(k)
            self.work += [(k, t) for t in range(c.frames)]
            points += int(c.points[k].sum())
            self.n += 1
            done += 1
            now = time.perf_counter()
            self.unit_s.append(now - (t0 + last))
            dt = last = now - t0
            if dt >= seconds:
                break
        self.window_s, self.attempted = dt, done
        return {"train_points_per_s": points / dt}

    def unit(self):
        k = self.ctx.order[self.n % self.ctx.pool_size]
        self.n += 1
        self.one(k)
        return self.ctx.frames

    def release(self):
        del self.model, self.state, self.train_step, self.params

    def check(self):
        from harness.check import training
        from reference import engine as ref
        c = self.ctx
        tr = c.config["train"]
        model, cfg = c.ref_model()
        windows = [(c.pos[k], c.val[k], c.lab[k], c.mask[k])
                   for k in c.order[:self.steps]]
        losses, g1, theta, logp1 = ref.train_steps(
            model, cfg, c.ref_rt, windows, tr["lr"], tr["weight_decay"],
            tr["ignore_index"])
        w0 = c.weights
        numbers = training(
            self.losses, losses, self.g1, g1,
            {n: self.theta[n] - w0[n] for n in theta},
            {n: theta[n] - w0[n] for n in theta},
            self.logp1, logp1, c.mask[c.order[0], -1])
        return numbers, 1
