"""The offline sequence forward's CUDA graphs
(``train/engine.SequenceGraphs``): the choice of graph keys and of the
eager path, the functional contract (inputs copied in, fresh outputs
handed back), the engine span's ``graph`` id and the benchmark's
``graph_sequences_pct`` reader.  On the CPU the
graphs are ``tests/test_torch_stream_graphs.py``'s stub of
``engine._capture``, whose replay runs the captured function again and
writes its results into the captured outputs in place; the test marked
``cuda`` holds real graphs against the eager path on the card.  Nothing
here imports JAX."""

import importlib.util
import os
import types

import pytest
import torch

from temporal_latticenet_tpu_torch.ops import _cuda
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.utils import profiling
from tests.test_torch_stream_graphs import (CFG, RT, StubGraph,  # noqa: F401
                                            _model, _sequences, _tensors,
                                            cuda_device, stub_graphs)


def _forward(model, monkeypatch=None):
    """The served offline forward; with ``monkeypatch``, its graph cache
    as if on the card (the stub replays on the CPU)."""
    fwd = engine.make_sequence_forward(model, CFG, RT)
    if monkeypatch is not None:
        monkeypatch.setattr(fwd.graphs, "card", True)
    return fwd


def _assert_same(a, b):
    """Two sequences' (logp, logits, aux) equal bit for bit."""
    (lp_a, sv_a, aux_a), (lp_b, sv_b, aux_b) = a, b
    assert torch.equal(lp_a, lp_b) and torch.equal(sv_a, sv_b)
    assert sorted(aux_a) == sorted(aux_b)
    for k in aux_a:
        assert torch.equal(aux_a[k], aux_b[k]), k


def test_sequence_graph_keys_replays_and_eager_fallbacks(stub_graphs,
                                                          monkeypatch):
    """One key (a lattice and a network graph) per shape of the positions,
    values and mask and per route of the pointnet max, captured after the
    key's first, eager sequence and replayed by every later one; replays
    equal the eager forward bit for bit and carry ``graph=1`` in their
    engine span, which holds the two replays' spans alone.  Off the card,
    with gradients on and inside ``sow_aux`` every sequence runs
    eagerly."""
    model = _model()
    seqs = _sequences()
    off_card = _forward(model)
    eager = [off_card(*s) for s in seqs]
    assert off_card.graphs.counts == {"captures": 0, "replays": 0,
                                      "eager": 2}
    assert stub_graphs.log == []

    fwd = _forward(model, monkeypatch)
    graphs = fwd.graphs
    with profiling.recording() as log:
        got = [fwd(*s) for s in seqs]
    for a, b in zip(got, eager):
        _assert_same(a, b)
    assert graphs.counts == {"captures": 1, "replays": 1, "eager": 1}
    assert stub_graphs.log == [("capture", 0), ("capture", 1),
                               ("replay", 0), ("replay", 1)]
    top = [r for r in log if r.layer == "engine" and r.parent is None]
    assert [r.name for r in top] == ["tln.engine.sequence"] * 2
    assert [r.ids["graph"] for r in top] == [0, 1]
    inner = [c for c in log if c.parent is top[1]]
    assert [c.name for c in inner] == ["tln.lattice.sequence",
                                       "tln.model.sequence"]
    assert not [c for c in log if c.parent in inner]

    # another point count is another key, and so is the packed route
    fwd(*_sequences(p=64)[0])
    assert graphs.counts == {"captures": 2, "replays": 1, "eager": 2}
    with monkeypatch.context() as env:
        env.setenv("TLN_MAXSCAN_PACKED", "1")
        fwd(*seqs[0])
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 3}

    # gradients on (the cache called without the entry point's no_grad)
    with torch.enable_grad():
        _assert_same(graphs("tln.engine.sequence", seqs[0]), eager[0])
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 4}

    # inside sow_aux: eager, and AFlow's records are made
    with model.sow_aux() as sown:
        _assert_same(fwd(*seqs[1]), eager[1])
    assert graphs.counts == {"captures": 3, "replays": 1, "eager": 5}
    assert len(sown["recurrent_fusion_modules_1"]["aflow_weights"]) == 2


def test_sequence_held_outputs_do_not_change(stub_graphs, monkeypatch):
    """Log-probabilities, logits and aux that the caller keeps stay as they
    were while the next sequence replays the same graphs."""
    model = _model()
    fwd = _forward(model, monkeypatch)
    seqs = _sequences()
    fwd(*seqs[1])                                   # capture
    out = fwd(*seqs[0])
    held = [x.clone() for x in _tensors(out)]
    fwd(*seqs[1])
    assert fwd.graphs.counts["replays"] == 2
    for x, y in zip(_tensors(out), held, strict=True):
        assert torch.equal(x, y)


def test_sequence_inputs_reach_the_static_buffers(stub_graphs,
                                                  monkeypatch):
    """A replayed sequence copies its positions, values and mask into its
    graphs' own static buffers; the values, which the lattice graph
    (``a``) and the network graph (``b``) both read, have one buffer, and
    the network's dropout generator, None, stays None."""
    fwd = _forward(_model(), monkeypatch)
    seqs = _sequences()
    fwd(*seqs[0])
    (g,) = fwd.graphs.graphs.values()
    assert g.b[0] is g.a[1] and g.b[1] is None
    fwd(*seqs[1])
    assert fwd.graphs.counts["replays"] == 1
    for x, y in zip(g.a, seqs[1], strict=True):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


def test_graph_sequences_pct_reads_the_sequence_spans(stub_graphs,
                                                      monkeypatch):
    """The benchmark's ``graph_sequences_pct`` reader on the span log of
    traced units: the share of ``tln.engine.sequence`` spans with
    ``graph=1``, 100 on replays and 0 on eager sequences; None where their
    number is not the traced sequences'."""
    reader = importlib.util.spec_from_file_location(
        "graph_sequences_pct", os.path.join(os.path.dirname(__file__), "..",
                                            "benchmark", "metrics",
                                            "graph_sequences_pct.py"))
    metric = importlib.util.module_from_spec(reader)
    reader.loader.exec_module(metric)

    def read(units):
        return metric.read(types.SimpleNamespace(
            layer={"trace": {"per": units}}))

    model = _model()
    fwd = _forward(model, monkeypatch)
    seqs = _sequences()
    with profiling.recording():
        fwd(*seqs[0])                               # warm-up, capture
    assert read(1) == 0.0
    with profiling.recording():
        fwd(*seqs[1])
        fwd(*seqs[0])
    assert read(2) == 100.0 and read(1) is None


@pytest.mark.cuda
def test_sequence_graphs_match_eager_on_the_card(cuda_device):
    """Two different sequences in turn, replayed from real CUDA graphs,
    against the eager forward (``sequence_forward`` without gradients) bit
    for bit; one key captured; no host sync inside a replayed forward
    (``utils/profiling.host_syncs``), and K1's wrapper counts no launch
    there (a replay calls no wrapper)."""
    model = _model(cuda_device)
    seqs = _sequences(cuda_device)
    eager_fwd = engine.sequence_forward(model, CFG, RT)
    with torch.no_grad():
        eager = [eager_fwd(*s) for s in seqs]
    fwd = _forward(model)
    got = [fwd(*s) for s in seqs + seqs]
    for a, b in zip(got, eager + eager):
        _assert_same(a, b)
    assert fwd.graphs.counts == {"captures": 1, "replays": 3, "eager": 1}
    with profiling.host_syncs():
        pass                        # torch's one-time notice of the mode
    torch.cuda.synchronize()
    before = _cuda.launch_counts()
    with profiling.host_syncs() as syncs:
        fwd(*seqs[1])
    torch.cuda.synchronize()
    assert syncs == {}
    assert _cuda.launch_counts() == before
