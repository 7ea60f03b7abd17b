"""One sensor stream: the pool's sequences one after another, scan by
scan, through the port's ``make_streaming_inference`` (a fresh state at
each sequence, ``step_fn`` on its non-final frames, ``final_fn`` on its
last).  A frame is timed from handing its scan to the engine to the host's
fetch of a value that depends on its result: the labels (argmax) of a
final frame, one value of the last fusion site's state on the others.

``frame_ms_p95``: the 95th percentile of the times of every frame of the
window."""

from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function

CHECKED = 3      # final frames the reference recomputes after the window


class Loop:
    traced_units = 2

    def __init__(self, ctx):
        from temporal_latticenet_tpu_torch.train.engine import \
            make_streaming_inference
        self.ctx = ctx
        self.model = ctx.port_model()
        self.model.eval()
        self.new, self.step, self.final = make_streaming_inference(
            self.model, ctx.cfg, ctx.rt)
        self.held, self.work, self.n = {}, [], 0
        self.state = None

    def per(self, frames):
        return frames                                # per frame

    def frame(self, k, t):
        """Serve frame ``t`` of sequence ``k``; returns the final frame's
        (logp, labels, aux), else None."""
        c = self.ctx
        if t == 0:
            self.state = self.new()
        p, v, m = c.pos[k, t], c.val[k, t], c.mask[k, t]
        if t < c.frames - 1:
            with record_function("bench.step_fn"):
                self.state = self.step(p, v, m, self.state)
            with record_function("bench.fetch_state"):
                h = [x for x in self.state.h if x.shape[0] > 1][-1]
                float(h[1, 0])
            return None
        with record_function("bench.final_fn"):
            logp, _, self.state, aux = self.final(p, v, m, self.state)
        with record_function("bench.fetch_labels"):
            labels = logp.argmax(dim=-1).cpu()
        return logp, labels, aux

    def setup(self):
        # every shape is the same for each sequence: one warms them all
        for t in range(self.ctx.frames):
            self.frame(self.ctx.order[0], t)

    def window(self, seconds):
        c = self.ctx
        times = []
        t0 = time.perf_counter()
        while True:
            k = c.order[(self.n // c.frames) % c.pool_size]
            t = self.n % c.frames
            s = time.perf_counter()
            out = self.frame(k, t)
            e = time.perf_counter()
            times.append((e - s) * 1e3)
            if out is not None:
                self.held[k] = out[:2]
            self.work.append((k, t))
            self.n += 1
            if e - t0 >= seconds and self.held:
                break
        self.window_s, self.attempted = e - t0, self.n
        self.unit_s = [x / 1e3 for x in times]
        return {"frame_ms_p95": statistics.quantiles(
            times, n=100, method="inclusive")[94]}

    def unit(self):
        """One whole sequence of the stream."""
        c = self.ctx
        k = c.order[(self.n // c.frames + 1) % c.pool_size]
        for t in range(c.frames):
            self.frame(k, t)
        self.n = (self.n // c.frames + 1) * c.frames
        return c.frames

    def release(self):
        del self.model, self.new, self.step, self.final, self.state

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
