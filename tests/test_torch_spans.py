"""The port's spans (``utils/profiling.span``) on the CPU: off outside a
profiler and ``recording()``, and under ``profiling.trace`` every layer
boundary's span in the Chrome trace, nested on its thread, for a sequence
forward, a streamed frame pair and a training step (whose
``tln.train.backward`` holds the custom backwards and full remat's
recompute)."""

import collections
import dataclasses
import json

import pytest
import torch

from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.train import engine, optim
from temporal_latticenet_tpu_torch.utils import profiling
from tests.torch_parallel_workers import tiny_batch

# tests/test_torch_streaming.py's tiny configuration: every fusion site
CFG = ModelConfig(nr_classes=5, pointnet_layers=(8, 16),
                  pointnet_start_nr_channels=16,
                  nr_blocks_down_stage=(1, 1, 1), nr_blocks_bottleneck=1,
                  nr_blocks_up_stage=(1, 1, 1),
                  rnn_modules=("gru", "gru", "aflow", "gru"),
                  frames_per_seq=3)
RT = RuntimeConfig(max_points=96, capacity_level0=1024, capacity_decay=0.5,
                   min_capacity=256, sigma=0.6)
TRIMMED = dataclasses.replace(RT, trim_capacity_level0=512,
                              final_capacity_level0=768)
FORWARD = {"tln.engine.sequence", "tln.lattice.build", "tln.lattice.level0",
           "tln.lattice.level1", "tln.lattice.level2", "tln.lattice.trim",
           "tln.lattice.frame", "tln.model.pointnet",
           "tln.model.fusion.early", "tln.model.down0",
           "tln.model.fusion.middle", "tln.model.coarsen0",
           "tln.model.down1", "tln.model.coarsen1", "tln.model.bottleneck",
           "tln.model.fusion.bottleneck", "tln.model.finefy0",
           "tln.model.finefy1", "tln.model.fusion.late", "tln.model.up",
           "tln.model.slice"}
STREAM = {"tln.engine.stream_step", "tln.engine.stream_final",
          "tln.lattice.frame", "tln.lattice.distribute",
          "tln.lattice.neighbors0", "tln.lattice.coarse1",
          "tln.lattice.neighbors1", "tln.lattice.coarse2",
          "tln.lattice.neighbors2", "tln.model.pointnet", "tln.model.slice"}
TRAIN = {"tln.engine.train_step", "tln.train.forward", "tln.train.loss",
         "tln.train.backward", "tln.train.optimizer",
         "tln.backward._Gather8Sym", "tln.backward._SplatSorted",
         "tln.backward._SliceSorted", "tln.backward._GatherRows",
         "tln.backward._SortedPackedMax"}
# the span each one sits in (by name prefix), on its thread
PARENTS = (("tln.lattice.level", "tln.lattice.build"),
           ("tln.lattice.distribute", "tln.lattice.frame"),
           ("tln.lattice.neighbors", "tln.lattice.frame"),
           ("tln.lattice.coarse", "tln.lattice.frame"),
           ("tln.model.fusion.early", "tln.model.pointnet"),
           ("tln.backward.", "tln.train.backward"),
           ("tln.train.", "tln.engine.train_step"),
           ("tln.lattice.", "tln.engine."), ("tln.model.", "tln.engine."))


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model = LNNSeq(CFG, RT, device="cpu")
    pos, val, lab, msk = (torch.from_numpy(a) for a in
                          tiny_batch(1, t=3, n=60, p=96))
    return model, pos[0], val[0], lab[0], msk[0]


def _stream(model, pos, val, msk):
    new, step, final = engine.make_streaming_inference(model, CFG, RT)
    state = step(pos[0], val[0], msk[0], new())
    return final(pos[1], val[1], msk[1], state)


def test_spans_off_outside_a_profiler(tiny, monkeypatch):
    """A streamed frame outside any profiler enters no ``record_function``
    and records nothing; ``recording()`` turns both on."""
    model, pos, val, _, msk = tiny
    entered = []
    real = profiling.record_function

    def counted(*args):
        entered.append(args[0])
        return real(*args)

    monkeypatch.setattr(profiling, "record_function", counted)
    assert profiling.span("tln.a") is profiling.span("tln.b", unit=1)
    before = list(profiling.span_log())
    _stream(model, pos, val, msk)
    assert entered == [] and list(profiling.span_log()) == before
    with profiling.recording() as log:
        _stream(model, pos, val, msk)
    assert set(entered) >= STREAM
    assert [r.name for r in log] == entered
    entered.clear()
    with profiling.recording(), profiling.without_spans():
        _stream(model, pos, val, msk)
    assert entered == []


def test_recording_logs_one_engine_span_a_unit(tiny):
    """Two sequence forwards and a stream of two frames: five outermost
    engine spans with increasing unit ids, the stream's with their frame;
    every span closed, inside its parent, with no device fields on the
    CPU."""
    model, pos, val, _, msk = tiny
    fwd = engine.make_sequence_forward(model, CFG, RT)
    with profiling.recording() as log:
        fwd(pos, val, msk)
        fwd(pos, val, msk)
        _stream(model, pos, val, msk)
    recs = list(log)
    top = [r for r in recs if r.layer == "engine" and r.parent is None]
    assert [r.name for r in top] == ["tln.engine.sequence"] * 2 + [
        "tln.engine.stream_step", "tln.engine.stream_final"]
    units = [r.ids["unit"] for r in top]
    assert units == sorted(set(units))
    assert [r.ids.get("frame") for r in top] == [None, None, 0, 1]
    assert {r.name for r in recs} >= (FORWARD - {"tln.lattice.trim"}) | STREAM
    for r in recs:
        assert r.ev0 is None and r.ev1 is None
        assert r.t0 <= r.t1
        if r.parent is None:
            assert r in top
        else:
            assert r.parent.t0 <= r.t0 and r.t1 <= r.parent.t1
            assert r.tid == r.parent.tid
    assert not profiling._recording


def _user_spans(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("tln.")]


def _nested(spans):
    """Every pair on one thread disjoint or one inside the other; returns
    {event index: the innermost enclosing event}."""
    parent = {}
    for i, e in enumerate(spans):
        s, t = e["ts"], e["ts"] + e["dur"]
        best = None
        for j, f in enumerate(spans):
            if j == i or f["tid"] != e["tid"]:
                continue
            fs, ft = f["ts"], f["ts"] + f["dur"]
            if ft <= s or t <= fs:
                continue
            inside = fs <= s and t <= ft
            assert inside or (s <= fs and ft <= t), (e["name"], f["name"])
            if inside and (fs, -ft) != (s, -t) and (
                    best is None or (fs, -ft) > (best["ts"],
                                                 -best["ts"] - best["dur"])):
                best = f
        parent[i] = best
    return parent


def test_trace_holds_the_spans_nested(tiny, tmp_path):
    """Under ``profiling.trace``: a trimmed sequence forward, a stream step
    and final, and a training step with full remat; each span of the
    tables inside its parent on its thread."""
    model, pos, val, lab, msk = tiny
    fwd = engine.make_sequence_forward(model, CFG, TRIMMED)
    train_step, _ = engine.make_train_step(model, CFG, RT)
    state = engine.TrainState(optim.make_optimizer(model.parameters(), 1e-3,
                                                   1e-3))
    batch = engine.SeqBatch(pos[None], val[None], lab[None], msk[None])
    with profiling.trace(str(tmp_path)):
        fwd(pos, val, msk)
        _stream(model, pos, val, msk)
        train_step(state, batch, 1.0)
    spans = _user_spans(tmp_path / profiling.TRACE_FILE)
    names = {e["name"] for e in spans}
    assert names >= FORWARD | STREAM | TRAIN
    parent = _nested(spans)
    for i, e in enumerate(spans):
        for child, want in PARENTS:
            if e["name"].startswith(child):
                chain, p = [], parent[i]
                while p is not None:
                    chain.append(p["name"])
                    p = parent[spans.index(p)]
                assert any(n.startswith(want) for n in chain), (e["name"],
                                                                chain)
                break
    # the backward's recompute runs the model inside tln.train.backward
    back = [e for e in spans if e["name"] == "tln.train.backward"]
    inner = [e for e in spans if e["name"] == "tln.model.pointnet"
             and any(b["ts"] <= e["ts"] <= b["ts"] + b["dur"] for b in back)]
    assert back and inner


def test_span_log_keeps_the_newest(monkeypatch):
    """Past its size the log drops its oldest records, and ``recording()``
    starts it empty."""
    monkeypatch.setattr(profiling, "_LOG", collections.deque(maxlen=4))
    with profiling.recording() as log:
        for i in range(6):
            with profiling.span(f"tln.engine.unit{i}", unit=i):
                pass
    assert [r.ids["unit"] for r in profiling.span_log()] == [2, 3, 4, 5]
    assert log is profiling.span_log()
    with profiling.recording() as log:
        assert len(log) == 0
