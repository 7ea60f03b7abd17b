"""The PyTorch port's non-batched (per-frame) pointnet route against the
JAX package on the CPU: bf16, float32 with and without
``reference_bary_quirk`` (offline, and through the streaming entry points),
and one bf16 ``grad_step`` through the packed
per-frame max's straight-through backward; ``segment_max_with_argmax`` and
the packed max's backward with ties, empty segments and invalid rows; and
the deform slice's gather backward, which leaves the rows that read the
invalid row 0 out.  Tolerances and helpers: ``test_torch_configs.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.blocks import DeformSlice
from temporal_latticenet_tpu_torch.ops import segment as tseg
from temporal_latticenet_tpu_torch.train import engine

from .test_torch_configs import (F32_ATOL, TINY, _agree_bf16, _clouds,  # noqa: F401
                                 _grad_step_matches, _jax_forward, _jparams,
                                 _one_torch_thread, _port, _same_structure)

# denser clouds than the other configurations' (fewer vertices than rows,
# so the bary quirk reads row 0's weight), with both trims active
RT_TRIM = dict(max_points=128, capacity_level0=1024, capacity_decay=0.5,
               min_capacity=256, sigma=0.6, trim_capacity_level0=768,
               final_capacity_level0=896, remat_mode="none")


# ---------------------------------------------------------------------------
# the non-batched route: per-frame pointnet over the sequence lattice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def per_frame():
    """The flagship's fusions at the tiny widths, 3 dense frames of 120
    points with both trims active; the JAX parameters (the same tree in
    bf16 and float32)."""
    cfg_kw = dict(TINY, rnn_modules=("gru", "gru", "aflow", "gru"))
    jrt = JRuntimeConfig(**RT_TRIM, batched_pointnet=False)
    data = _clouds(3, 128, 120, 1.0, 1)
    jparams = _jparams(JModelConfig(**cfg_kw), jrt,
                       tuple(a[0] for a in (data[0], data[1], data[3])))
    return dict(cfg_kw=cfg_kw, jrt=jrt,
                rt=RuntimeConfig(**RT_TRIM, batched_pointnet=False),
                data=data, jparams=jparams)


def _per_frame_forward(per_frame, precompute=True, **cfg_kw):
    """The offline forward (precompute=True), or the streaming forward
    (precompute=False: frame by frame through the streaming entry points,
    which take no trims), against the JAX package's own."""
    kw = dict(per_frame["cfg_kw"], **cfg_kw)
    pos, val, _, mask = per_frame["data"]
    want, jaux = _jax_forward(per_frame["jparams"], JModelConfig(**kw),
                              per_frame["jrt"], (pos, val, mask), precompute)
    cfg, rt = ModelConfig(**kw), per_frame["rt"]
    assert rt.trim_capacities(2)[0] < rt.capacities(2)[0]
    assert rt.final_capacities(2)[0] < rt.capacities(2)[0]
    got, _, aux = engine.make_sequence_forward(
        _port(per_frame["jparams"], cfg, rt), cfg, rt,
        precompute=precompute)(pos, val, mask)
    _same_structure(aux, jaux)
    assert not bool(aux["vertex_overflow"])
    return got, want, mask[-1]


def test_per_frame_route_bf16_matches_jax(per_frame):
    got, want, valid = _per_frame_forward(per_frame)
    _agree_bf16(got, want, valid)


@pytest.mark.parametrize("quirk", [False, True])
def test_per_frame_route_float32_matches_jax(per_frame, quirk):
    got, want, valid = _per_frame_forward(
        per_frame, compute_dtype="float32", reference_bary_quirk=quirk)
    assert np.isfinite(got.numpy()[valid]).all()
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("quirk", [False, True])
def test_streaming_float32_matches_jax(per_frame, quirk):
    """Float32 through the streaming entry points: the per-frame pointnet
    over the carried vertex tables, whose counts the quirk reads."""
    got, want, valid = _per_frame_forward(
        per_frame, precompute=False, compute_dtype="float32",
        reference_bary_quirk=quirk)
    assert np.isfinite(got.numpy()[valid]).all()
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0,
                               atol=F32_ATOL)


def test_bary_quirk_changes_the_float32_forward(per_frame):
    """At these clouds most winning rows lie past the vertex count, so the
    quirk is material (it is the reference's behaviour, not noise)."""
    pos, val, _, mask = per_frame["data"]
    rt = per_frame["rt"]
    out = []
    for quirk in (False, True):
        cfg = ModelConfig(**per_frame["cfg_kw"], compute_dtype="float32",
                          reference_bary_quirk=quirk)
        model = _port(per_frame["jparams"], cfg, rt)
        out.append(engine.make_sequence_forward(model, cfg, rt)(
            pos, val, mask)[0].numpy()[mask[-1]])
    assert np.abs(out[0] - out[1]).max() > 1e-3


def test_per_frame_route_bf16_grad_step_matches_jax(per_frame):
    """The packed per-frame max's straight-through backward, end to end."""
    kw = per_frame["cfg_kw"]
    _grad_step_matches(per_frame["jparams"], JModelConfig(**kw),
                       per_frame["jrt"], ModelConfig(**kw), per_frame["rt"],
                       per_frame["data"])


# ---------------------------------------------------------------------------
# the per-frame maxima and their backward; the deform slice's gather
# ---------------------------------------------------------------------------

def _max_inputs(seed=4, r=5000, c=16, segs=700):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((r, c)).astype(np.float32)
    data[::7] = data[::7].round(1)                       # ties
    bary = rng.random(r).astype(np.float32)
    ids = rng.integers(0, segs - 50, r)                  # empty segments
    valid = rng.random(r) > 0.2                          # invalid rows
    cot = rng.standard_normal((2, segs, c)).astype(np.float32)
    return data, bary, ids, valid, segs, cot


def test_segment_max_with_argmax_matches_jax():
    data, _, ids, valid, segs, cot = _max_inputs()
    args = (jnp.asarray(ids), segs, jnp.asarray(valid))
    (jmx, jarg), vjp = jax.vjp(
        lambda d: jseg.segment_max_with_argmax(d, *args), jnp.asarray(data))
    (jgrad,) = vjp((jnp.asarray(cot[0]), np.zeros(jarg.shape,
                                                  jax.dtypes.float0)))
    x = torch.from_numpy(data).requires_grad_()
    mx, arg = tseg.segment_max_with_argmax(x, torch.from_numpy(ids), segs,
                                           torch.from_numpy(valid))
    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    assert (arg[-50:] == -1).all() and (mx[-50:] == 0).all()
    mx.backward(torch.from_numpy(cot[0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)
    assert (x.grad.numpy()[~valid] == 0).all()


def test_segment_max_with_bary_packed_backward_matches_jax():
    data, bary, ids, valid, segs, cot = _max_inputs(seed=5)
    xb = jnp.asarray(data).astype(jnp.bfloat16)
    (jmx, jb), vjp = jax.vjp(
        lambda d, b: jseg.segment_max_with_bary_packed(
            d, b, jnp.asarray(ids), segs, jnp.asarray(valid)),
        xb, jnp.asarray(bary))
    jdx, jdb = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    x = torch.from_numpy(data).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(bary).requires_grad_()
    mx, bs = tseg.segment_max_with_bary_packed(x, b, torch.from_numpy(ids),
                                               segs, torch.from_numpy(valid))
    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(bs.detach().numpy(), np.asarray(jb))
    torch.autograd.backward((mx, bs), (torch.from_numpy(cot[0]),
                                       torch.from_numpy(cot[1])))
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(jdx).astype(np.float32))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb), rtol=1e-6,
                               atol=1e-6)


def test_deform_gather_backward_matches_index_put():
    """The deform slice's gather leaves the rows that read row 0 out of its
    backward; every row's gradient is the plain indexing's (autograd's
    ``index_put_`` accumulate), and so is every parameter's."""
    rng = np.random.default_rng(8)
    cap, c, p = 600, 24, 2000
    values = rng.standard_normal((cap, c)).astype(np.float32)
    values[0] = 0
    idx = rng.integers(1, 500, (p, 4))
    idx[rng.random(p) < 0.3] = 0                     # masked points
    bary = np.where(idx > 0, rng.random((p, 4)), 0).astype(np.float32)
    idx, bary = torch.from_numpy(idx), torch.from_numpy(bary)
    cot = torch.from_numpy(rng.standard_normal((p, 5)).astype(np.float32))
    mod = DeformSlice(c, 5)
    mod.linear_clasify.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():   # a nonzero deform head
        mod.linear_deltaW.weight.copy_(torch.from_numpy(
            rng.standard_normal((4, 4 * c + 4)).astype(np.float32) * 0.01))
        mod.linear_deltaW.bias.zero_()
    grads = []
    for forward in (mod, functools.partial(_plain_deform, mod)):
        v = torch.from_numpy(values).requires_grad_()
        mod.zero_grad()
        forward(v, idx, bary).backward(cot)
        grads.append((v.grad, {k: q.grad.clone()
                               for k, q in mod.named_parameters()}))
    (gv, gp), (wv, wp) = grads
    # masked points carry zero weights, so row 0's cotangent is zero in the
    # plain backward as well: leaving those rows out changes nothing
    assert (gv[0] == 0).all() and (wv[0] == 0).all()
    np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-6, atol=1e-6)
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), wp[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _plain_deform(mod, values, point_vertex, point_bary):
    """``DeformSlice.forward`` with the plain indexing gather (whose
    backward is autograd's ``index_put_`` accumulate)."""
    g = values[point_vertex]
    feats = g.reshape(g.shape[0], -1)
    delta = mod.linear_deltaW(torch.cat([feats, point_bary], dim=-1))
    delta = torch.where(point_bary != 0.0, delta, torch.zeros(()))
    sliced = torch.einsum("pvc,pv->pc", g, point_bary + delta)
    return mod.linear_clasify(sliced)
