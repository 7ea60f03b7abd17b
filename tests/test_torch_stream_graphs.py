"""The plain stream's CUDA graphs (``train/engine.StreamGraphs``): the
engine-built frame against the model's own per-frame path, the choice of
graph keys and of the eager path, and the functional contract (inputs
copied in, fresh outputs handed back).  On the CPU the graphs are a stub
in place of ``engine._capture`` whose replay runs the captured function
again and writes its results into the captured outputs in place, as a
CUDA graph's replay does; the test marked ``cuda`` holds real graphs
against the eager path on the card.  Nothing here imports JAX."""

import dataclasses
import importlib.util
import os
import types

import pytest
import torch

from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.lnn_seq import (SITES, LNNSeq,
                                                         SeqState, init_state,
                                                         site_level)
from temporal_latticenet_tpu_torch.ops import _cuda
from temporal_latticenet_tpu_torch.ops.lattice_ops import NeighborTable
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.utils import profiling
from tests.torch_parallel_workers import tiny_batch

# tests/test_torch_streaming.py's tiny configuration: every fusion site,
# AFlow at the bottleneck, three frames
CFG = ModelConfig(nr_classes=5, pointnet_layers=(8, 16),
                  pointnet_start_nr_channels=16,
                  nr_blocks_down_stage=(1, 1, 1), nr_blocks_bottleneck=1,
                  nr_blocks_up_stage=(1, 1, 1),
                  rnn_modules=("gru", "gru", "aflow", "gru"),
                  frames_per_seq=3)
RT = RuntimeConfig(max_points=96, capacity_level0=1024, capacity_decay=0.5,
                   min_capacity=256, sigma=0.6)
T = CFG.frames_per_seq


def _sequences(device="cpu", p=96):
    """Two sequences of T frames, (positions, values, mask) each."""
    pos, val, _, msk = tiny_batch(2, seed=3, t=T, n=60, p=p)
    return [tuple(torch.from_numpy(a[b]).to(device) for a in (pos, val, msk))
            for b in range(2)]


def _model(device="cpu"):
    return LNNSeq(CFG, RT, device=device, seed=0).eval()


def _tensors(x):
    """Every tensor of a nested output, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return _tensors([getattr(x, f.name) for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return _tensors([x[k] for k in sorted(x)])
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _run(fns, seq):
    """One sequence through (new, step, final): the final frame's (logp,
    logits, state, aux) and the state after each frame."""
    new, step, final = fns
    pos, val, msk = seq
    state, states = new(), []
    for t in range(T - 1):
        state = step(pos[t], val[t], msk[t], state)
        states.append(state)
    out = final(pos[-1], val[-1], msk[-1], state)
    states.append(out[2])
    return out, states


def _assert_states_equal(a, b):
    assert a.t == b.t
    assert [int(c) for c in a.prev_counts] == [int(c) for c in b.prev_counts]
    for x, y in zip(_tensors((a.h, a.tables)), _tensors((b.h, b.tables))):
        assert torch.equal(x, y)


def _assert_same(a, b):
    """Two runs' (final outputs, states) equal bit for bit."""
    (lp_a, sv_a, _, aux_a), states_a = a
    (lp_b, sv_b, _, aux_b), states_b = b
    assert torch.equal(lp_a, lp_b) and torch.equal(sv_a, sv_b)
    assert sorted(aux_a) == sorted(aux_b)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k]), k
    for sa, sb in zip(states_a, states_b, strict=True):
        _assert_states_equal(sa, sb)


class StubGraph:
    """In place of a captured CUDA graph: ``replay`` runs the captured
    function again and writes its results into the captured outputs in
    place.  ``log`` records ("capture" | "replay", graph index)."""

    log = []

    def __init__(self, fn, out):
        self.fn, self.out, self.index = fn, out, len(StubGraph.graphs)
        StubGraph.graphs.append(self)
        StubGraph.log.append(("capture", self.index))

    def replay(self):
        StubGraph.log.append(("replay", self.index))
        with profiling.without_spans():            # a replay runs no Python
            fresh = self.fn()
        for dst, src in zip(_tensors(self.out), _tensors(fresh), strict=True):
            dst.copy_(src)


@pytest.fixture
def stub_graphs(monkeypatch):
    StubGraph.log, StubGraph.graphs = [], []

    def capture(fn, pool):
        assert pool == "pool"
        out = fn()
        return StubGraph(fn, out), out

    monkeypatch.setattr(engine, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    return StubGraph


def _card(fns):
    """The engine's graphs as if on the card (the stub replays on the
    CPU)."""
    fns[1].graphs.card = True
    return fns


def test_plain_stream_equals_the_models_own_frames():
    """The engine builds each frame's structures and hands them to the
    model: bit-equal to ``model(state, positions=..., values=...,
    mask=...)`` frame by frame, over two sequences: log-probabilities,
    logits, aux, fusion states, tables and counts."""
    model = _model()
    fns = engine.make_streaming_inference(model, CFG, RT)
    for seq in _sequences():
        got = _run(fns, seq)
        pos, val, msk = seq
        state, states = init_state(CFG, RT, "cpu", tables=True), []
        with torch.no_grad():
            for t in range(T):
                out, state, aux = model(state, positions=pos[t],
                                        values=val[t], mask=msk[t],
                                        final=t == T - 1)
                states.append(state)
        _assert_same(got, ((*out, state, aux), states))
    assert fns[1].graphs.counts == {"captures": 0, "replays": 0,
                                    "eager": 2 * T}


def test_graph_keys_replays_and_eager_fallbacks(stub_graphs, monkeypatch):
    """One key (two graphs) per first / later frame, early return / final,
    shapes and route of the pointnet max, captured after the key's first,
    eager frame and replayed by every later one; replays equal the eager
    path bit for bit and carry ``graph=1`` in their engine span.  Off the
    card and inside ``sow_aux`` every frame runs eagerly; a caller's
    autograd does not reach the graphs, which the step functions call
    without it."""
    model = _model()
    seqs = _sequences()
    eager = [_run(engine.make_streaming_inference(model, CFG, RT), s)
             for s in seqs]

    off_card = engine.make_streaming_inference(model, CFG, RT)
    _run(off_card, seqs[0])
    assert off_card[1].graphs.counts["captures"] == 0
    assert stub_graphs.log == []

    fns = _card(engine.make_streaming_inference(model, CFG, RT))
    graphs = fns[1].graphs
    with profiling.recording() as log:
        first = _run(fns, seqs[0])
        second = _run(fns, seqs[1])
    _assert_same(first, eager[0])
    _assert_same(second, eager[1])
    assert graphs.counts == {"captures": 3, "replays": T, "eager": T}
    assert sorted((k[0], k[1]) for k in graphs.graphs) == [
        (False, False), (False, True), (True, False)]
    # each capture is a lattice and a network graph, replayed in turn
    assert [e for e in stub_graphs.log if e[0] == "capture"] == [
        ("capture", i) for i in range(6)]
    assert [e for e in stub_graphs.log if e[0] == "replay"] == [
        ("replay", i) for i in range(6)]
    # a replayed frame's engine span holds the two replays' spans alone
    top = [r for r in log if r.layer == "engine" and r.parent is None]
    assert [r.ids["graph"] for r in top] == [0] * T + [1] * T
    for r in top[T:]:
        inner = [c for c in log if c.parent is r]
        assert [c.name for c in inner] == ["tln.lattice.frame",
                                           "tln.model.frame"]
        assert not [c for c in log if c.parent in inner]

    # another frame shape is another key
    _run(fns, _sequences(p=64)[0])
    assert graphs.counts == {"captures": 6, "replays": T, "eager": 2 * T}
    assert len(graphs.graphs) == 6

    # autograd on in the caller: the step function turns it off and replays
    pos, val, msk = seqs[0]
    with torch.enable_grad():
        state = fns[1](pos[0], val[0], msk[0], fns[0]())
    assert graphs.counts["replays"] == T + 1
    _assert_states_equal(state, eager[0][1][0])

    # inside sow_aux: eager, and AFlow's records are made
    with model.sow_aux() as sown:
        _run(fns, seqs[1])
    assert graphs.counts == {"captures": 6, "replays": T + 1,
                             "eager": 3 * T}
    assert len(sown["recurrent_fusion_modules_1"]["aflow_weights"]) == T - 1

    # the packed route of the pointnet max is another key
    with monkeypatch.context() as env:
        env.setenv("TLN_MAXSCAN_PACKED", "1")
        _assert_same(_run(fns, seqs[0]), eager[0])
    assert graphs.counts == {"captures": 9, "replays": T + 1,
                             "eager": 4 * T}


def test_held_outputs_do_not_change(stub_graphs):
    """A final frame's log-probabilities and a state that the caller keeps
    stay as they were while the next sequence replays the same graphs."""
    model = _model()
    fns = _card(engine.make_streaming_inference(model, CFG, RT))
    seqs = _sequences()
    _run(fns, seqs[1])                               # capture every key
    (logp, sv, state, aux), states = _run(fns, seqs[0])
    held = [x.clone() for x in _tensors((logp, sv, state, aux, states))]
    _run(fns, seqs[1])
    assert fns[1].graphs.counts["replays"] == 2 * T
    for x, y in zip(_tensors((logp, sv, state, aux, states)), held,
                    strict=True):
        assert torch.equal(x, y)


def _second_frame(fns, seqs):
    """Frame 1 of ``seqs[1]``, replayed from the graphs that frame 1 of
    ``seqs[0]`` captured: (those graphs, the frame's (p, v, m), the state it
    took, the state it gave)."""
    new, step, _ = fns
    for pos, val, msk in seqs:
        before = step(pos[0], val[0], msk[0], new())
        after = step(pos[1], val[1], msk[1], before)
    assert step.graphs.counts == {"captures": 2, "replays": 2, "eager": 2}
    (graphs,) = [g for k, g in step.graphs.graphs.items()
                 if k[:2] == (False, False)]
    return graphs, (pos[1], val[1], msk[1]), before, after


def test_frame_inputs_reach_the_static_buffers(stub_graphs):
    """A replayed frame copies every tensor leaf of its inputs into its
    graphs' own static buffers: the frame's positions and mask and every
    field of every level's table for the lattice graph (``a``); its
    values, the fusion states and the prev_counts for the network graph
    (``b``).  A prev_count is its level's table count, one tensor in ``a``
    and ``b``: it has one buffer."""
    g, (p, v, m), before, _ = _second_frame(
        _card(engine.make_streaming_inference(_model(), CFG, RT)),
        _sequences())
    for static, want in ((g.a, (p, m, before.tables)),
                         (g.b, (v, before.h, before.prev_counts))):
        got, ref = _tensors(static), _tensors(want)
        assert len(got) == len(ref) > 0
        for x, y in zip(got, ref, strict=True):
            assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    tables, prev = before.tables, before.prev_counts
    assert len(prev) == 4 and all(
        any(c is tb.count for tb in tables) for c in prev)
    buffers = [tb.count for tb in g.a[2]]
    assert all(any(c is b for b in buffers) for c in g.b[2])


def test_replayed_outputs_share_one_clone_of_a_shared_tensor(stub_graphs):
    """The network graph's new state holds each prev_count as the very
    tensor of its level's table count; a replayed frame hands back one
    fresh clone of it, the same tensor in both places, as an eager frame
    hands back one tensor."""
    g, _, before, after = _second_frame(
        _card(engine.make_streaming_inference(_model(), CFG, RT)),
        _sequences())
    _, static, _ = g.out
    for state in (before, static, after):
        for site, c in zip(SITES, state.prev_counts, strict=True):
            assert c is state.tables[site_level(CFG, site)].count, site
    held = {id(x) for x in _tensors(static)}
    assert not [x for x in _tensors(after) if id(x) in held]
    assert len({id(x) for x in _tensors(after)}) == len(held)


def test_non_tensor_leaves_pass_through(stub_graphs):
    """The walker rebuilds tuples, lists, dicts, NamedTuples and
    dataclasses and hands on what is not a tensor as it is.  The first
    frame's Python prev_counts reach its captured network unchanged, and a
    replayed frame's state counts on from the caller's ``t``."""
    x, gen = torch.ones(2), torch.Generator()
    tree = (1, [None, "s", x], {"g": gen, "x": x}, NeighborTable(x, x),
            SeqState(h=(x,), prev_counts=(1, x), t=3))
    got = engine._tree_map(lambda a: a + 1, tree)
    assert type(got) is tuple and type(got[1]) is list
    assert type(got[3]) is NeighborTable and type(got[4]) is SeqState
    assert got[0] == 1 and got[1][:2] == [None, "s"] and got[2]["g"] is gen
    assert got[4].t == 3 and got[4].prev_counts[0] == 1
    assert got[4].tables is None
    assert all(torch.equal(a, x + 1) for a in engine._leaves(got))
    assert len(engine._leaves(got)) == 6

    fns = _card(engine.make_streaming_inference(_model(), CFG, RT))
    seqs = _sequences()
    _run(fns, seqs[0])
    graphs = fns[1].graphs
    (first,) = [g for k, g in graphs.graphs.items() if k[0]]
    assert first.b[2] == (1, 1, 1, 1)
    _, states = _run(fns, seqs[1])
    assert graphs.counts["replays"] == T
    assert [s.t for s in states] == list(range(1, T + 1))


def test_a_tensor_in_both_parts_is_copied_once(stub_graphs):
    """A tensor that both parts read (the offline values) has one static
    buffer, copied once a replay; a tensor of another identity in its
    place in ``b`` is copied into it after the lattice graph replays."""

    class Counted(torch.Tensor):
        copies = 0

        def copy_(self, src, non_blocking=False):
            Counted.copies += 1
            return super().copy_(src, non_blocking)

    def lattice(p, v):
        return p * v

    def network(structures, v, gen):
        return {"out": structures + v, "gen": gen}

    p, v = torch.arange(3.0), torch.full((3,), 2.0)
    g = engine._UnitGraphs(lattice, network, (p, v), (v, None), "pool")
    assert g.b[0] is g.a[1] and g.b[1] is None
    memo = {}
    g.a, g.b = (engine._tree_map(
        lambda t: memo.setdefault(id(t), t.as_subclass(Counted)), x)
        for x in (g.a, g.b))
    p2, v2 = torch.arange(3.0) + 1, torch.full((3,), 3.0)
    out = g((p2, v2), (v2, None), "test", {})
    assert Counted.copies == 2
    assert torch.equal(out["out"], p2 * v2 + v2) and out["gen"] is None
    out = g((p2, v2), (v2 + 1, None), "test", {})
    assert Counted.copies == 5
    assert torch.equal(out["out"], p2 * v2 + v2 + 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphs_match_eager_on_the_card(cuda_device):
    """Two sequences replayed from real CUDA graphs against the eager
    path, bit for bit; 3 keys captured, every frame after a key's first
    replayed.  K1's wrapper counts its real launches alone: once a frame
    on the eager path, once an eager frame on the graph path (a capture
    launches nothing, a replay calls no wrapper)."""
    model = _model(cuda_device)
    seqs = _sequences(cuda_device)
    eager_fns = engine.make_streaming_inference(model, CFG, RT)
    eager_fns[1].graphs.card = False
    fns = engine.make_streaming_inference(model, CFG, RT)
    before = _cuda.launch_counts()
    eager = [_run(eager_fns, s) for s in seqs]
    mid = _cuda.launch_counts()
    got = [_run(fns, s) for s in seqs]
    after = _cuda.launch_counts()
    for a, b in zip(got, eager):
        _assert_same(a, b)
    assert fns[1].graphs.counts == {"captures": 3, "replays": 2 * T - 3,
                                    "eager": 3}
    assert eager_fns[1].graphs.counts["eager"] == 2 * T
    assert mid["fused_simplex_pack"] - before["fused_simplex_pack"] == 2 * T
    assert after["fused_simplex_pack"] - mid["fused_simplex_pack"] == 3


def test_graph_frames_pct_reads_the_stream_spans(stub_graphs):
    """The benchmark's ``graph_frames_pct`` reader on the span log of
    traced units: the share of stream engine spans with ``graph=1``; None
    where the spans carry no ``graph`` id (the incremental path's) or their
    number is not the traced frames'."""
    reader = importlib.util.spec_from_file_location(
        "graph_frames_pct", os.path.join(os.path.dirname(__file__), "..",
                                         "benchmark", "metrics",
                                         "graph_frames_pct.py"))
    metric = importlib.util.module_from_spec(reader)
    reader.loader.exec_module(metric)

    def read(frames):
        return metric.read(types.SimpleNamespace(
            layer={"trace": {"frames": frames}}))

    model = _model()
    fns = _card(engine.make_streaming_inference(model, CFG, RT))
    seqs = _sequences()
    with profiling.recording():
        _run(fns, seqs[0])                           # warm-ups, captures
        _run(fns, seqs[1])                           # replays
    assert read(2 * T) == 50.0 and read(T) is None
    with profiling.recording():
        _run(fns, seqs[0])
    assert read(T) == 100.0
    inc = engine.make_streaming_inference_incremental(model, CFG, RT)
    with profiling.recording():
        s, fs = inc[0]()
        s, fs = inc[1](*(a[0] for a in seqs[0]), s, fs)
    assert read(1) is None
