"""The port's optimizer against the JAX package's optax chain on the SAME
numpy gradients (so bf16 gradient noise plays no part: one AdamW step turns
any sign flip of a tiny gradient into a 2 lr difference), and the
learning-rate schedules against the JAX package's.

Tolerance: parameters to 1e-6 relative (float32; torch divides by
``sqrt(v) / sqrt(bc2) + eps`` where optax takes ``sqrt(v / bc2) + eps``).
Where a step nearly cancels an element, the optax chain's own float32
result strays from a float64 evaluation of the same rule by more than 1e-6
of the element (up to 1.4e-8 absolute, measured over these inputs), so the
port is held to the optax result to 1e-6 relative plus 2e-8 absolute (2e-5
of the step lr), and to the float64 evaluation to 1e-6 relative alone
(measured: 3.4e-7 at most).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from temporal_latticenet_tpu.train import optim as joptim
from temporal_latticenet_tpu_torch.train import optim

RTOL = 1e-6
ATOL_VS_OPTAX = 2e-8


def _amsgrad_f64(params, grads, scales, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """The JAX package's amsgrad chain in float64."""
    p = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v = {k: np.zeros_like(x) for k, x in p.items()}
    vmax = {k: np.zeros_like(x) for k, x in p.items()}
    for n, (g, s) in enumerate(zip(grads, scales), start=1):
        for k in p:
            gk = g[k].astype(np.float64)
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            vmax[k] = np.maximum(vmax[k], v[k])
            u = (m[k] / (1 - b1 ** n)) / (np.sqrt(vmax[k] / (1 - b2 ** n))
                                          + eps)
            p[k] = p[k] - lr * s * (u + wd * p[k])
    return p


def _params_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    shapes = {"w": (37, 11), "b": (11,), "zero": (5, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["zero"][:] = 0
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    for g in grads:
        g["zero"][:] = 0                   # a parameter the loss misses
    return params, grads


@pytest.mark.parametrize("steps,scales", [(1, [1.0]),
                                          (4, [1.0, 0.5, 0.25, 0.9])])
def test_adamw_amsgrad_matches_optax(steps, scales):
    lr, wd = 1e-3, 1e-3
    params, grads = _params_and_grads(steps, steps)

    tx = joptim.make_optimizer(lr, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g, s in zip(grads, scales):
        state.hyperparams["lr_scale"] = jnp.asarray(s, jnp.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = optim.make_optimizer(list(tp.values()), lr, wd)
    for g, s in zip(grads, scales):
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        optim.set_lr_scale(opt, s)
        opt.step()
    ref = _amsgrad_f64(params, grads, scales, lr, wd)
    for k, p in tp.items():
        got, want = p.detach().numpy(), np.asarray(jp[k])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_VS_OPTAX,
                                   err_msg=k)
        np.testing.assert_allclose(got, ref[k], rtol=RTOL, atol=0, err_msg=k)
        if k != "zero":
            assert not np.array_equal(got, params[k])


def test_lr_scale_sets_every_group():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = optim.make_optimizer([p], 2e-3, 0.0)
    optim.set_lr_scale(opt, 0.25)
    assert [g["lr"] for g in opt.param_groups] == [5e-4]
    assert opt.param_groups[0]["amsgrad"] and opt.param_groups[0]["eps"] == 1e-8


def test_schedules_match_jax():
    for e in np.linspace(0, 7.5, 31):
        assert optim.cosine_warm_restarts(e, 3.0) == \
            joptim.cosine_warm_restarts(e, 3.0)
        assert optim.cosine_warm_restarts(e, 2.0, 0.1) == \
            joptim.cosine_warm_restarts(e, 2.0, 0.1)
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1, 0.5, 5), np.full(30, 0.7),
                              rng.random(20)])
    a, b = optim.ReduceLROnPlateau(patience=3), joptim.ReduceLROnPlateau(
        patience=3)
    assert [a.step(float(m)) for m in metrics] == \
        [b.step(float(m)) for m in metrics]
    assert a.scale < 1.0
