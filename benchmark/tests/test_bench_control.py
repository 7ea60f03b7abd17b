"""The precision control at the small size of ``tiny.py``: the reference
computed with float8 operands (``benchmark/control.py``), put in the
port's place, comes out not correct under each cell's limits.  The card
reads it at the cells' own size (PERF.md section 2)."""

import pytest
import torch

import tiny  # noqa: I001  (puts benchmark/ on sys.path first)
import control
from harness import check
from harness.core import Context


@pytest.mark.parametrize("workload", ["flagship.offline", "gru3.stream",
                                      "flagship.train"])
def test_control_is_not_correct(workload):
    _, config, traffic, lims = tiny.cell(workload)
    ctx = Context(tiny.BENCH, workload, config, traffic, 13,
                  torch.device("cpu"))
    ctx.make_inputs()
    ctx.make_weights()
    if traffic["loop"] == "train":
        numbers = control.control_training(ctx, traffic["check_steps"])
    else:
        numbers = control.control_served(ctx, range(ctx.pool_size))
    ok, checked = check.verdict(numbers, lims)
    assert not ok, checked
