"""A run of each cell with the look for a chip skipped (on the CPU, at the
small size of ``tiny.py``, the port in float32 so that a sound run reads
next to nothing), with the timed path broken underneath
(``harness/faults.py``): ``correct`` comes out false for every fault that
the cell can have."""

import pytest

import tiny
from harness import faults


def run(workload, monkeypatch, fault=None):
    from harness import core
    real = core.Context.__init__

    def float32(self, bench_dir, workload, config, traffic, seed, device):
        config = dict(config, model=dict(config["model"],
                                         compute_dtype="float32"))
        real(self, bench_dir, workload, config, traffic, seed, device)
    monkeypatch.setattr(core.Context, "__init__", float32)
    if fault is None:
        return tiny.run(workload, seed=11, seconds=0.1)
    with faults.plant(fault):
        return tiny.run(workload, seed=11, seconds=0.1)


@pytest.mark.parametrize("workload,fault", [
    ("flagship.offline", None), ("flagship.offline", "state_unchanged"),
    ("flagship.offline", "answer_altered"),
    ("gru3.stream", None), ("gru3.stream", "state_unchanged"),
    ("gru3.stream", "answer_altered"),
    ("flagship.train", None), ("flagship.train", "step_unchanged"),
    ("flagship.train", "answer_altered"),
    ("flagship.train", "state_unchanged"),
    ("flagship.train", "gather_backward_negated")])
def test_fault_is_caught(workload, fault, monkeypatch):
    out = run(workload, monkeypatch, fault)
    assert out["correct"] is (fault is None), out["checked"]
