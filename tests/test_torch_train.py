"""The PyTorch port's flagship training step against the JAX package's on the
CPU: the loss and every parameter's gradient of ``grad_step``, with the JAX
weights carried through ``params_from_jax``, plus the step's own contract
(at the ``TINY`` widths, without JAX: remat modes, metrics, the optimizer
step, dropout, batches, what is not ported).

Geometry: 4 frames of 1,024 padded points, all three trims active (the
inputs of ``tests/test_torch_forward.py``).  Tolerances: both sides round
the same operands to bf16 and accumulate in float32 in different orders,
and in the backward the gradients of the bf16 operands are rounded to bf16
as well, so a last-bit difference can flip a later rounding.  The loss is
held to 1e-2, each parameter's gradient to a cosine of at least 0.99 with
JAX's, and the global gradient norm to 2 %.  Measured (this geometry, CPU,
one torch thread, the same in every run): |d loss| 2.3e-4, smallest cosine
0.99362 (the first pointnet layer's weight, whose gradient sums over every
union row after the bf16 rounding of the straight-through max), global
norm 0.032 % above JAX's (on eight threads 0.99419 and 0.033 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu.train import optim as joptim
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_torch_configs import RT as CONFIGS_RT
# torch on one thread for the whole file: beside the suite's other workers
# an OpenMP team waits on its slowest thread at every operation, and on
# more threads the CPU's ``index_put_`` accumulate (the gathers' backward)
# adds with atomics, so a step's gradients change from run to run; on one
# thread they are a fixed left fold (scripts/torch_cpu_determinism.py)
from .test_torch_configs import TINY, _clouds, _one_torch_thread  # noqa: F401

P = 1024
RT = dict(max_points=P, capacity_level0=8192, capacity_decay=0.5,
          min_capacity=5120, sigma=0.5, trim_capacity_level0=5120,
          final_capacity_level0=6656, remat_mode="full")
LOSS_ATOL = 1e-2
GRAD_COSINE = 0.99
NORM_RTOL = 0.02


@pytest.fixture(scope="module")
def jparams():
    cfg = JModelConfig()
    tiny = JRuntimeConfig(max_points=64, capacity_level0=256,
                          capacity_decay=0.5, min_capacity=64, sigma=0.6)
    p = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    init = jax.jit(lambda k, p_, v_, m_, s: JLNNSeq(cfg, tiny).init(
        k, p_, v_, m_, s, final=True))
    var = init(jax.random.PRNGKey(0), jnp.asarray(p * 5), jnp.ones((64, 1)),
               jnp.ones((64,), bool), j_init_state(cfg, tiny))
    return jax.tree_util.tree_map(np.asarray, var["params"])


@pytest.fixture(scope="module")
def batch():
    pos, val, lab, mask = lidar_sequence(np.random.default_rng(0), frames=4,
                                         max_points=P, n_az=P // 64)
    return tuple(a[None] for a in (pos, val, lab, mask))


@pytest.fixture(scope="module")
def jax_grads(jparams, batch):
    jcfg, jrt = JModelConfig(), JRuntimeConfig(**RT)
    tx = joptim.make_optimizer(1e-3, 1e-3)
    train_step, _ = jengine.make_train_step(JLNNSeq(jcfg, jrt), jcfg, jrt, tx)
    jb = jengine.SeqBatch(*(jnp.asarray(a) for a in batch))
    loss, grads = train_step.grad_step({"params": jparams}, jb, jnp.int32(0))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads["params"])


def _port_step(jparams):
    """The port's flagship training step on JAX's weights."""
    cfg, rt = ModelConfig(), RuntimeConfig(**RT)
    model, _ = engine.create_train_state(cfg, rt, 1e-3, 1e-3, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg), strict=True)
    return engine.make_train_step(model, cfg, rt)[0]


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b / (na * nb))


def test_flagship_grad_step_matches_jax(jparams, batch, jax_grads):
    jloss, jgrads = jax_grads
    want = params_from_jax(jgrads, ModelConfig())
    train_step = _port_step(jparams)
    loss, grads = train_step.grad_step(engine.SeqBatch(*batch))
    assert abs(float(loss) - jloss) <= LOSS_ATOL
    assert sorted(grads) == sorted(want)
    norms = {}
    for name, g in grads.items():
        g, w = g.numpy(), want[name].numpy()
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert _cosine(g, w) >= GRAD_COSINE, (name, _cosine(g, w))
        norms[name] = (np.sum(g.astype(np.float64) ** 2),
                       np.sum(w.astype(np.float64) ** 2))
    got_norm = np.sqrt(sum(a for a, _ in norms.values()))
    want_norm = np.sqrt(sum(b for _, b in norms.values()))
    assert abs(got_norm - want_norm) <= NORM_RTOL * want_norm


# the step's contract (metrics, the update, dropout, batches, what raises)
# needs no JAX weights: it runs at tests/test_torch_configs.py's TINY widths
# with the flagship fusions, on that file's 3 frames of 96 points (80 real)
TINY_RT = dict(CONFIGS_RT, remat_mode="full")


@pytest.fixture(scope="module")
def tiny_batch():
    return tuple(a[None] for a in _clouds(3, 96, 80, 2.0, 0))


def _tiny(rt=TINY_RT, **cfg_kw):
    cfg = ModelConfig(**dict(TINY, **cfg_kw))
    rt = RuntimeConfig(**rt)
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3,
                                             device="cpu")
    train_step, eval_step = engine.make_train_step(model, cfg, rt)
    return model, state, train_step, eval_step


@pytest.mark.parametrize("remat,packed", [
    pytest.param("none", False, id="none"),
    pytest.param("selective", False, id="selective"),
    pytest.param("none", True, id="none-packed"),
    pytest.param("selective", True, id="selective-packed")])
def test_remat_modes_give_the_same_gradients(batch, remat, packed,
                                             monkeypatch):
    """Rematerialisation recomputes the same functions on the same inputs,
    so the loss is bit-equal to full remat's; autograd sums a parameter's
    gradient contributions in another order, which can flip a bf16
    rounding of an operand gradient, so the gradients are held to a cosine
    of 0.9999.  The ``TINY`` widths with the flagship's geometry and
    classes: its 4 frames of 1,024 points and its trims, the same seed-0
    weights in both models; the pointnet max on the default route (one K4
    scan) and on the packed one (``TLN_MAXSCAN_PACKED=1``: K5, then K4 over
    its summaries).  Measured at the flagship widths
    (scripts/torch_cpu_determinism.py): 1.000000000 on one thread in every
    run; 0.99994554 and 0.99999794 in two runs on 8 threads of 8 idle
    cores."""
    monkeypatch.setenv("TLN_MAXSCAN_PACKED", "1" if packed else "0")
    full, other = (_tiny(dict(RT, remat_mode=m), frames_per_seq=4,
                         nr_classes=ModelConfig().nr_classes)
                   for m in ("full", remat))
    other[0].load_state_dict(full[0].state_dict())
    b = engine.SeqBatch(*batch)
    loss_f, g_f = full[2].grad_step(b)
    loss_o, g_o = other[2].grad_step(b)
    assert float(loss_f) == float(loss_o)
    for name in g_f:
        assert _cosine(g_f[name].numpy(), g_o[name].numpy()) >= 0.9999, name


def test_train_step_metrics_and_update(tiny_batch):
    model, state, train_step, eval_step = _tiny()
    b = engine.SeqBatch(*tiny_batch)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    logp_e, m_e = eval_step(b)
    state, logp, m = train_step(state, b, 0.5)
    assert state.step == 1
    assert logp.shape == (1, TINY_RT["max_points"], TINY["nr_classes"])
    assert torch.equal(logp, logp_e)        # same forward before the update
    assert sorted(m) == ["grad_norm", "loss", "lovasz", "nll", "nr_vertices",
                         "vertex_overflow"]
    assert float(m["loss"]) == float(m_e["loss"])
    np.testing.assert_allclose(float(m["loss"]),
                               0.5 * float(m["lovasz"]) + 0.5 * float(m["nll"]),
                               rtol=1e-6)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert not bool(m["vertex_overflow"])
    lr = state.optimizer.param_groups[0]["lr"]
    assert lr == pytest.approx(0.5e-3)
    # every parameter with a gradient or a value moved; the only one with
    # neither is AFlow's unused, zero-initialised conv weight, which has a
    # zero gradient (not None) as in the JAX package
    for k, v in model.named_parameters():
        assert v.grad is not None, k
        if before[k].any() or v.grad.any():
            assert not torch.equal(v.detach(), before[k]), k
        else:
            assert k.endswith("AFLOW.weight"), k
    # the no-gradient forward of loss_step sees the updated weights
    _, m2 = train_step.loss_step(b)
    assert float(m2["loss"]) != float(m["loss"])


def test_unported_training_options_raise(tiny_batch):
    """Unknown remat modes raise; a batch of two sequences runs (the mean
    of its losses, (2, P, K) log-probabilities).  Dropout in the slice head
    runs: the training step takes it, and ``eval_step`` stays
    deterministic."""
    model, state, d_train, d_eval = _tiny(dropout_last_layer=0.2)
    small = engine.SeqBatch(*(a[:, :2] for a in tiny_batch))
    state, _, m = d_train(state, small, 1.0)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert 0.15 < float(m["dropped_share"]) < 0.25
    (a, ma), (b, mb) = d_eval(small), d_eval(small)
    assert torch.equal(a, b) and float(ma["loss"]) == float(mb["loss"])
    model, _, train_step, eval_step = _tiny()
    two = engine.SeqBatch(*(np.concatenate([a, a]) for a in tiny_batch))
    logp2, m2 = eval_step(two)
    logp1, m1 = eval_step(engine.SeqBatch(*tiny_batch))
    assert logp2.shape == (2, TINY_RT["max_points"], TINY["nr_classes"])
    assert torch.equal(logp2[0], logp1[0]) and torch.equal(logp2[1], logp1[0])
    assert float(m2["loss"]) == float(m1["loss"])
    with pytest.raises(ValueError):
        engine.sequence_forward(model, model.cfg, model.rt, remat="some")
