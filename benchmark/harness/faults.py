"""Faults planted in the port's timed path, to show that the numbers of
``harness/check.py`` catch them (``benchmark/tests/test_bench_faults.py``
on the CPU; ``benchmark/control.py --fault`` reads them on the card):

* ``state_unchanged``: every non-final frame hands on the fusion state it
  was given;
* ``answer_altered``: the last frame's log-probabilities come out rolled
  by one class where the model produces them (an off-by-one class index);
* ``step_unchanged``: the port's optimizer step leaves the weights as they
  were;
* ``gather_backward_negated``: the neighborhood gather's backward (every
  lattice convolution's and AFlow's) returns the cotangent with its sign
  flipped.

One batch of one sequence and one chip leave no half batch and no
exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _forward_patch(after):
    from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
    real = LNNSeq.forward

    def forward(self, state, *args, final=True, **kwargs):
        out, new, aux = real(self, state, *args, final=final, **kwargs)
        return after(state, final, out, new, aux)
    return _patched(LNNSeq, "forward", forward)


def _state_unchanged(state, final, out, new, aux):
    if not final:
        new = dataclasses.replace(new, h=state.h,
                                  prev_counts=state.prev_counts)
    return out, new, aux


def _answer_altered(state, final, out, new, aux):
    if final:
        logp, sv = out
        out = (torch.roll(logp, 1, dims=-1), sv)
    return out, new, aux


def _gather_backward_negated():
    from temporal_latticenet_tpu_torch.ops.lattice_ops import _Gather8Sym
    real = _Gather8Sym.backward

    def backward(ctx, dg):
        g, none = real(ctx, dg)
        return -g, none
    return _patched(_Gather8Sym, "backward", staticmethod(backward))


FAULTS = ("state_unchanged", "answer_altered", "step_unchanged",
          "gather_backward_negated")


def plant(name: str):
    """A context in which the port runs with the fault ``name``."""
    if name == "state_unchanged":
        return _forward_patch(_state_unchanged)
    if name == "answer_altered":
        return _forward_patch(_answer_altered)
    if name == "step_unchanged":
        from temporal_latticenet_tpu_torch.train import optim
        real = optim.make_optimizer

        def make_optimizer(*args, **kwargs):
            opt = real(*args, **kwargs)
            opt.step = lambda *a, **k: None
            return opt
        return _patched(optim, "make_optimizer", make_optimizer)
    if name == "gather_backward_negated":
        return _gather_backward_negated()
    raise ValueError(f"no fault {name!r}; the faults are {FAULTS}")
