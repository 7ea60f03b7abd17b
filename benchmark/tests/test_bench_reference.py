"""The benchmark's float32 reference against the port's plain CPU path at
a small size, and the modules the harness and the reference load."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the repository and benchmark/ on sys.path)
from harness.core import Context
from reference import engine as ref


def context(workload, compute_dtype="float32", seed=5):
    _, config, traffic, _ = tiny.cell(workload)
    config["model"]["compute_dtype"] = compute_dtype
    ctx = Context(tiny.BENCH, workload, config, traffic, seed,
                  torch.device("cpu"))
    ctx.make_inputs()
    ctx.make_weights()
    return ctx


@pytest.mark.parametrize("workload", ["flagship.offline", "gru3.stream"])
def test_forward_matches_port_float32(workload):
    from temporal_latticenet_tpu_torch.train.engine import \
        make_sequence_forward
    ctx = context(workload)
    model = ctx.port_model()
    model.eval()
    fwd = make_sequence_forward(model, ctx.cfg, ctx.rt)
    rmodel, rcfg = ctx.ref_model()
    for k in range(ctx.pool_size):
        lp, _, _ = fwd(ctx.pos[k], ctx.val[k], ctx.mask[k])
        with torch.no_grad():
            r, _, _ = ref.forward(rmodel, rcfg, ctx.ref_rt, ctx.pos[k],
                                  ctx.val[k], ctx.mask[k])
        m = ctx.mask[k, -1]
        assert torch.allclose(lp[m], r[m], atol=1e-5, rtol=0)


def test_forward_bf16_within_rounding():
    """The port's bf16 route (batched pointnet) stays near the float32
    reference: most labels agree."""
    from temporal_latticenet_tpu_torch.train.engine import \
        make_sequence_forward
    ctx = context("flagship.offline", "bfloat16")
    model = ctx.port_model()
    model.eval()
    lp, _, _ = make_sequence_forward(model, ctx.cfg, ctx.rt)(
        ctx.pos[0], ctx.val[0], ctx.mask[0])
    rmodel, rcfg = ctx.ref_model()
    with torch.no_grad():
        r, _, _ = ref.forward(rmodel, rcfg, ctx.ref_rt, ctx.pos[0],
                              ctx.val[0], ctx.mask[0])
    m = ctx.mask[0, -1]
    assert (lp.argmax(-1) == r.argmax(-1))[m].float().mean() > 0.9


def test_training_steps_match_port_float32():
    from temporal_latticenet_tpu_torch.train import optim
    from temporal_latticenet_tpu_torch.train.engine import (
        SeqBatch, TrainState, make_train_step)
    ctx = context("flagship.train")
    tr = ctx.config["train"]
    torch.set_num_threads(1)
    model = ctx.port_model()
    state = TrainState(optim.make_optimizer(model.parameters(), tr["lr"],
                                            tr["weight_decay"]))
    step, _ = make_train_step(model, ctx.cfg, ctx.rt)
    losses = []
    for k in ctx.order[:2]:
        batch = SeqBatch(ctx.pos[k][None], ctx.val[k][None],
                         ctx.lab[k][None], ctx.mask[k][None])
        state, _, m = step(state, batch, 1.0)
        losses.append(float(m["loss"]))
    rmodel, rcfg = ctx.ref_model()
    windows = [(ctx.pos[k], ctx.val[k], ctx.lab[k], ctx.mask[k])
               for k in ctx.order[:2]]
    rl, _, theta, _ = ref.train_steps(rmodel, rcfg, ctx.ref_rt, windows,
                                      tr["lr"], tr["weight_decay"])
    np.testing.assert_allclose(losses, rl, rtol=1e-4)
    for n, p in model.named_parameters():
        d_port = (p.detach() - ctx.weights[n]).norm()
        d_ref = (theta[n] - ctx.weights[n]).norm()
        assert abs(float(d_port - d_ref)) <= 1e-3 * max(float(d_ref), 1e-6) + 1e-6


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tiny.ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    """Everything a run imports (the harness, every loop and metric, the
    reference, the port's entries): no module whose top-level name is jax,
    jaxlib, flax or temporal_latticenet_tpu, compared whole."""
    code = f"""
import sys, glob, os
sys.path[:0] = [{tiny.BENCH!r}, {tiny.ROOT!r}]
from harness import core, check, trace, traffic, weights
from reference import engine
for sub in ("loops", "metrics"):
    for f in glob.glob(os.path.join({tiny.BENCH!r}, sub, "*.py")):
        core.load_file(f, "m_" + os.path.basename(f).replace(".", "_"))
import temporal_latticenet_tpu_torch.train.engine
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _loaded(code)
    assert "temporal_latticenet_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "temporal_latticenet_tpu"}


def test_reference_loads_nothing_of_the_port():
    code = f"""
import sys
sys.path[:0] = [{tiny.BENCH!r}]
from reference import engine
from reference.models import lnn_seq
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "temporal_latticenet_tpu",
                      "temporal_latticenet_tpu_torch"}
