"""The reduction of the port's span log (``harness/program_spans.py``) on a
hand-written log: two units of a training step, nesting on two threads,
an autograd-thread span that outlasts ``tln.train.backward`` and overlaps
the optimizer, and a gap with a span outside every engine span."""

import types

import pytest

import tiny  # noqa: F401  (puts the benchmark and the checkout on the path)
from harness import program_spans as ps
from temporal_latticenet_tpu_torch.utils import profiling


class Event:
    """A CUDA timing event's stand-in: ``elapsed_time`` in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _log(device=True):
    """(name, parent's name, thread, start ms, end ms), in entry order; the
    device clock reads 2 * host + 1."""
    rows = [("tln.engine.train_step", None, 1, 0, 100),
            ("tln.train.forward", "tln.engine.train_step", 1, 5, 40),
            ("tln.engine.sequence", "tln.train.forward", 1, 6, 39),
            ("tln.lattice.build", "tln.engine.sequence", 1, 8, 20),
            ("tln.lattice.level0", "tln.lattice.build", 1, 9, 15),
            ("tln.model.pointnet", "tln.engine.sequence", 1, 22, 35),
            ("tln.train.loss", "tln.engine.train_step", 1, 42, 45),
            ("tln.train.backward", "tln.engine.train_step", 1, 50, 90),
            ("tln.backward._Gather8Sym", "tln.train.backward", 2, 55, 60),
            ("tln.model.down0", "tln.train.backward", 2, 62, 70),
            ("tln.backward._SliceSorted", "tln.train.backward", 2, 85, 95),
            ("tln.train.optimizer", "tln.engine.train_step", 1, 92, 98),
            ("tln.lattice.trim", None, 1, 150, 160),
            ("tln.engine.train_step", None, 1, 200, 210),
            ("tln.model.slice", "tln.engine.train_step", 1, 202, 206)]
    recs, by = [], {}
    for name, parent, tid, s, e in rows:
        r = profiling.SpanRecord(name, {})
        r.tid, r.parent = tid, by.get(parent)
        r.t0, r.t1 = int(s * 1e6), int(e * 1e6)
        if device:
            r.ev0, r.ev1 = Event(2 * s + 1), Event(2 * e + 1)
        recs.append(r)
        by[name] = r
    return recs


# host ms owned over both units, by the rule (each instant inside an
# engine span to the open span entered last)
OWNED = {"tln.engine.train_step": 20.0, "tln.train.forward": 2.0,
         "tln.engine.sequence": 8.0, "tln.lattice.build": 6.0,
         "tln.lattice.level0": 6.0, "tln.model.pointnet": 13.0,
         "tln.train.loss": 3.0, "tln.train.backward": 22.0,
         "tln.backward._Gather8Sym": 5.0, "tln.model.down0": 8.0,
         "tln.backward._SliceSorted": 7.0, "tln.train.optimizer": 6.0,
         "tln.model.slice": 4.0}


def test_reduction_gives_exact_ms():
    red = ps.reduce_log(_log(), 2)
    assert red["host"] == pytest.approx({k: v / 2 for k, v in OWNED.items()})
    assert red["device"] == pytest.approx({k: v for k, v in OWNED.items()})
    host = red["host"]
    assert ps.total(host, "lattice") == pytest.approx(6.0)
    assert ps.total(host, "model") == pytest.approx(12.5)
    assert ps.total(host, "backward") == pytest.approx(17.0)
    assert ps.total(host, "covered") == pytest.approx(40.0)
    line = ps.spans_line(red)
    assert line.startswith("spans: ")
    assert "cover 72.7 % / 72.7 %" in line


def test_unmatched_units_and_no_device_give_none():
    assert ps.reduce_log(_log(), 3) is None
    assert ps.reduce_log([], 0) is None
    red = ps.reduce_log(_log(device=False), 2)
    assert red["device"] is None and red["host"]["tln.model.slice"] == 2.0


def test_readers_read_the_ports_log(monkeypatch, capsys):
    """The readers through the port's ``span_log``: one ``spans:`` line,
    None without a trace or where the log does not match."""
    monkeypatch.setattr(profiling, "span_log", lambda: _log())
    ctx = types.SimpleNamespace(layer={"trace": {"per": 2.0}})
    assert ps.layer_ms(ctx, "lattice", "host") == pytest.approx(6.0)
    assert ps.layer_ms(ctx, "model", "device") == pytest.approx(25.0)
    assert ps.layer_ms(ctx, "backward", "device") == pytest.approx(34.0)
    assert capsys.readouterr().err.count("spans: ") == 1
    assert ps.layer_ms(types.SimpleNamespace(layer={}), "model",
                       "host") is None
    ctx = types.SimpleNamespace(layer={"trace": {"per": 1.0}})
    assert ps.layer_ms(ctx, "model", "host") is None
    monkeypatch.setattr(profiling, "span_log", lambda: _log(device=False))
    ctx = types.SimpleNamespace(layer={"trace": {"per": 2.0}})
    assert ps.layer_ms(ctx, "model", "device") is None
    assert ps.layer_ms(ctx, "model", "host") == pytest.approx(12.5)
