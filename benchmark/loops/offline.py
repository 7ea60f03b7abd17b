"""Offline labelling: the pool's sequences back to back through the port's
``make_sequence_forward``, one at a time; each sequence ends when its last
frame's labels (the argmax) reach the host.

``offline_points_per_s``: the real points of every frame of every sequence
finished in the window, over the window's seconds."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

CHECKED = 3      # sequences the reference recomputes after the window


class Loop:
    traced_units = 2

    def __init__(self, ctx):
        from temporal_latticenet_tpu_torch.train.engine import \
            make_sequence_forward
        self.ctx = ctx
        self.model = ctx.port_model()
        self.model.eval()
        self.fwd = make_sequence_forward(self.model, ctx.cfg, ctx.rt)
        self.held, self.work, self.n = {}, [], 0

    def per(self, frames):
        return frames / self.ctx.frames          # per sequence

    def one(self, k):
        c = self.ctx
        with record_function("bench.forward"):
            logp, _, aux = self.fwd(c.pos[k], c.val[k], c.mask[k])
        with record_function("bench.fetch_labels"):
            labels = logp.argmax(dim=-1).cpu()
        return logp, labels, aux

    def setup(self):
        # every shape is the same for each sequence: one warms them all
        self.one(self.ctx.order[0])

    def window(self, seconds):
        c = self.ctx
        points = 0
        self.unit_s, last = [], 0.0
        t0 = time.perf_counter()
        while True:
            k = c.order[self.n % c.pool_size]
            logp, labels, _ = self.one(k)
            self.held[k] = (logp, labels)
            self.work += [(k, t) for t in range(c.frames)]
            points += int(c.points[k].sum())
            self.n += 1
            now = time.perf_counter()
            self.unit_s.append(now - (t0 + last))
            dt = last = now - t0
            if dt >= seconds:
                break
        self.window_s, self.attempted = dt, self.n
        return {"offline_points_per_s": points / dt}

    def unit(self):
        k = self.ctx.order[self.n % self.ctx.pool_size]
        self.n += 1
        self.one(k)
        return self.ctx.frames

    def release(self):
        del self.model, self.fwd

    def check(self):
        from harness.check import merge, served
        from reference import engine as ref
        c = self.ctx
        model, cfg = c.ref_model()
        readings = []
        with torch.no_grad():
            for k in c.sample(self.held, CHECKED):
                logp, labels = self.held[k]
                r, _, _ = ref.forward(model, cfg, c.ref_rt, c.pos[k],
                                      c.val[k], c.mask[k])
                readings.append(served(logp, labels, r, c.mask[k, -1]))
                del r
        return merge(readings), len(readings)
