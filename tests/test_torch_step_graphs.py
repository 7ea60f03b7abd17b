"""The training step's CUDA graphs (``train/engine.StepGraphs``): the choice
of graph keys and of the eager path, the gradients bound to the parameters
before AdamW reads them (the warm-up's own, then each replay's), served
steps against the eager step, the engine span's ``graph`` id, the
benchmark's ``graph_steps_pct`` reader, and the host-sync-free pairing of
``_Gather8Sym.backward``.  On the CPU the graphs are
``tests/test_torch_stream_graphs.py``'s stub of ``engine._capture``, whose
replay runs the captured function again and writes its results into the
captured outputs in place; the test marked ``cuda`` holds real graphs
against the eager step on the card.  Nothing here imports JAX."""

import dataclasses
import importlib.util
import os
import types

import pytest
import torch

from temporal_latticenet_tpu_torch.ops import lattice_ops as lo
from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.utils import profiling
from tests.test_torch_stream_graphs import (CFG, RT, T,  # noqa: F401
                                            StubGraph, _tensors, cuda_device,
                                            stub_graphs)
from tests.torch_parallel_workers import tiny_batch

STEPS = 3


@pytest.fixture
def one_thread():
    """One CPU thread: with more, a backward's sums may differ from run to
    run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _windows(device="cpu", p=96, n=STEPS):
    """``n`` distinct labelled windows (batch 1) of T frames."""
    out = []
    for s in range(n):
        arrays = tiny_batch(1, seed=10 + s, t=T, n=60, p=p)
        out.append(engine.SeqBatch(*(torch.from_numpy(a).to(device)
                                     for a in arrays)))
    return out


def _trainer(device="cpu", card=None, cfg=CFG, **kw):
    """The tiny model (seed 0), its AdamW state and its steps; ``card``
    True serves the steps from the (stub) graphs on the CPU."""
    model, state = engine.create_train_state(cfg, RT, 1e-3, 1e-3, seed=0,
                                             device=device)
    train_step, eval_step = engine.make_train_step(model, cfg, RT, **kw)
    if card is not None:
        train_step.graphs.card = card
    return model, state, train_step, eval_step


def _run(trainer, windows):
    """Each window's (loss, logp, gradients) after its step, and the
    parameters at the end."""
    model, state, train_step, _ = trainer
    out = []
    for w in windows:
        state, logp, m = train_step(state, w, 1.0)
        out.append((m["loss"].clone(), logp.clone(),
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
    return out, {k: p.detach().clone() for k, p in model.named_parameters()}


def _assert_same_steps(a, b):
    (steps_a, theta_a), (steps_b, theta_b) = a, b
    for (loss_a, logp_a, g_a), (loss_b, logp_b, g_b) in zip(
            steps_a, steps_b, strict=True):
        assert torch.equal(loss_a, loss_b) and torch.equal(logp_a, logp_b)
        for k in g_a:
            assert torch.equal(g_a[k], g_b[k]), k
    for k in theta_a:
        assert torch.equal(theta_a[k], theta_b[k]), k


def test_served_steps_equal_the_eager_steps(stub_graphs, one_thread):
    """Three windows (one key): the first step runs eagerly and its key's
    lattice and network graphs are captured, the next two replay them;
    losses, logp, every gradient and the parameters after each step equal
    the eager step's bit for bit.  Each step holds one engine span, with
    ``graph`` 0 and then 1; a replayed step's holds the two replays' spans
    and the optimizer's alone."""
    windows = _windows()
    eager = _trainer()
    want = _run(eager, windows)
    assert eager[2].graphs.counts == {"captures": 0, "replays": 0,
                                      "eager": STEPS}
    assert stub_graphs.log == []

    served = _trainer(card=True)
    with profiling.recording() as log:
        got = _run(served, windows)
    _assert_same_steps(got, want)
    assert served[2].graphs.counts == {"captures": 1, "replays": 2,
                                       "eager": 1}
    assert stub_graphs.log == [("capture", 0), ("capture", 1),
                               ("replay", 0), ("replay", 1),
                               ("replay", 0), ("replay", 1)]
    top = [r for r in log if r.layer == "engine" and r.parent is None]
    assert [r.name for r in top] == ["tln.engine.train_step"] * STEPS
    assert [r.ids["graph"] for r in top] == [0, 1, 1]
    replayed = list(log)[list(log).index(top[1]):]
    assert [r.name for r in replayed] == [
        "tln.engine.train_step", "tln.lattice.step", "tln.model.step",
        "tln.train.optimizer"] * 2
    assert all(r.parent is top[1] for r in replayed[1:4])


def test_step_graph_keys_and_eager_fallbacks(stub_graphs, monkeypatch):
    """One key per shape of the positions, values, labels and mask and per
    route of the pointnet max.  Off the card, with dropout, with a mesh,
    with gradients off and inside ``sow_aux`` a step runs eagerly, and so
    do ``grad_step``, ``loss_step`` and ``eval_step`` whatever the card."""
    model, state, train_step, eval_step = _trainer(card=True)
    graphs = train_step.graphs
    w, other = _windows(n=1)[0], _windows(p=64, n=1)[0]
    state, _, _ = train_step(state, w, 1.0)
    state, _, _ = train_step(state, other, 1.0)
    assert graphs.counts == {"captures": 2, "replays": 0, "eager": 2}
    with monkeypatch.context() as env:
        env.setenv("TLN_MAXSCAN_PACKED", "1")
        state, _, _ = train_step(state, w, 1.0)
    assert graphs.counts == {"captures": 3, "replays": 0, "eager": 3}
    state, _, _ = train_step(state, w, 1.0)
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 3}

    # the other entry points never touch the graphs
    train_step.grad_step(w)
    train_step.loss_step(w)
    eval_step(w)
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 3}

    # inside sow_aux, and off the card
    with model.sow_aux():
        state, _, _ = train_step(state, w, 1.0)
    graphs.card = False
    state, _, _ = train_step(state, w, 1.0)
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 5}
    assert len(StubGraph.graphs) == 6

    # gradients off: not replayable (the step itself needs them)
    graphs.card = True
    with torch.no_grad():
        assert not graphs.replayable()
    assert graphs.replayable()

    # dropout, a mesh: never replayable
    drop = _trainer(card=True, cfg=dataclasses.replace(
        CFG, dropout_last_layer=0.2))
    mesh = pmesh.Mesh(rank=0, world_size=1, device=torch.device("cpu"),
                      group=None)
    meshed = _trainer(card=True, mesh=mesh)
    assert not drop[2].graphs.replayable()
    assert not meshed[2].graphs.replayable()
    _, state, step, _ = drop
    step(state, w, 1.0)
    assert step.graphs.counts == {"captures": 0, "replays": 0, "eager": 1}


def test_warm_up_gradients_reach_adamw(stub_graphs, monkeypatch,
                                       one_thread):
    """A real capture computes nothing: its outputs, the gradients it
    leaves in ``.grad`` among them, hold whatever the pool held.  Here the
    capture fills them with NaN; the warm-up step's AdamW still reads the
    warm-up's own gradients, which stay bound to the parameters, and the
    parameters equal the eager step's."""
    capture = engine._capture

    def poisoned(fn, pool):
        graph, out = capture(fn, pool)
        for x in _tensors(out):                 # the gradients among them
            if x.is_floating_point():
                x.fill_(float("nan"))
        return graph, out

    monkeypatch.setattr(engine, "_capture", poisoned)
    windows = _windows(n=1)
    want = _run(_trainer(), windows)
    model, state, train_step, _ = trainer = _trainer(card=True)
    got = _run(trainer, windows)
    assert train_step.graphs.counts["captures"] == 1
    _assert_same_steps(got, want)
    for p in model.parameters():
        assert torch.isfinite(p.grad).all() and torch.isfinite(p).all()


def test_grad_rebound_after_an_eager_grad_step(stub_graphs, one_thread):
    """An eager ``grad_step`` between two replayed steps leaves its own
    gradients in ``.grad``; the next replay binds each parameter's
    ``.grad`` to the replay's gradients again, so AdamW reads the step's
    own and the parameters follow the eager steps'."""
    windows = _windows()
    want = _run(_trainer(), windows)
    model, state, train_step, _ = _trainer(card=True)
    out = []
    for i, w in enumerate(windows):
        if i == 2:
            _, held = train_step.grad_step(windows[0])
            assert all(p.grad is held[k]
                       for k, p in model.named_parameters())
        state, logp, m = train_step(state, w, 1.0)
        out.append((m["loss"].clone(), logp.clone(),
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
        if i == 2:
            assert not any(p.grad is held[k]
                           for k, p in model.named_parameters())
    assert train_step.graphs.counts == {"captures": 1, "replays": 2,
                                        "eager": 1}
    got = (out, {k: p.detach().clone() for k, p in model.named_parameters()})
    _assert_same_steps(got, want)


def test_graph_steps_pct_reads_the_step_spans(stub_graphs):
    """The benchmark's ``graph_steps_pct`` reader on the span log of traced
    steps: the share of ``tln.engine.train_step`` spans with ``graph=1``,
    0 on the warm-up and 100 on replays; None where their number is not the
    traced steps'."""
    reader = importlib.util.spec_from_file_location(
        "graph_steps_pct", os.path.join(os.path.dirname(__file__), "..",
                                        "benchmark", "metrics",
                                        "graph_steps_pct.py"))
    metric = importlib.util.module_from_spec(reader)
    reader.loader.exec_module(metric)

    def read(units):
        return metric.read(types.SimpleNamespace(
            layer={"trace": {"per": units}}))

    _, state, train_step, _ = _trainer(card=True)
    windows = _windows(n=2)
    with profiling.recording():
        state, _, _ = train_step(state, windows[0], 1.0)
    assert read(1) == 0.0
    with profiling.recording():
        for w in windows:
            state, _, _ = train_step(state, w, 1.0)
    assert read(2) == 100.0 and read(1) is None


def test_gather8_sym_backward_pairs_taps_by_a_roll():
    """``_Gather8Sym.backward`` pairs the taps by a roll on the device;
    its cotangent equals the one through the pairing as a Python list
    index, bit for bit, on a random table with empty taps (zeros)."""
    g = torch.Generator().manual_seed(5)
    cap, cin = 300, 7
    idx8 = torch.randint(0, cap, (cap, 8), generator=g)
    idx8[torch.rand((cap, 8), generator=g) < 0.3] = 0
    dg = torch.randn((cap, 8, cin), generator=g)
    dg[0] = 0
    got, none = lo._Gather8Sym.backward(
        types.SimpleNamespace(saved_tensors=(idx8,)), dg)
    inv = idx8[:, [(k + 4) % 8 for k in range(8)]]
    fi = inv * 8 + torch.arange(8)[None, :]
    g8 = dg.reshape(cap * 8, cin)[fi]
    want = torch.where((inv > 0)[..., None], g8,
                       torch.zeros(())).sum(dim=1)
    assert none is None and torch.equal(got, want)


@pytest.mark.cuda
def test_step_graphs_match_eager_on_the_card(cuda_device):
    """Three replayed steps (after the warm-up) against eager steps from
    the same weights on the same windows: losses, gradients and parameters
    within the eager path's own run-to-run difference, measured here on a
    second eager run (bit-equal where that is 0); a replayed step makes no
    host sync (``torch.cuda.set_sync_debug_mode("error")``)."""
    windows = _windows(cuda_device, n=STEPS + 1)
    runs = [_run(_trainer(cuda_device, card=False), windows)
            for _ in range(2)]
    served = _trainer(cuda_device)
    got = _run(served, windows)
    assert served[2].graphs.counts == {"captures": 1, "replays": STEPS,
                                       "eager": 1}

    def gaps(a, b):
        (steps_a, theta_a), (steps_b, theta_b) = a, b
        out = []
        for (la, pa, ga), (lb, pb, gb) in zip(steps_a, steps_b):
            out += [(la - lb).abs().max(), (pa - pb).abs().max()]
            out += [(ga[k] - gb[k]).abs().max() for k in ga]
        out += [(theta_a[k] - theta_b[k]).abs().max() for k in theta_a]
        return torch.stack(out).float()

    allowed = gaps(runs[0], runs[1])
    assert bool((gaps(got, runs[0]) <= allowed).all())

    model, state, train_step, _ = served
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, windows[0], 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert train_step.graphs.counts["replays"] == STEPS + 1
