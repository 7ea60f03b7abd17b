"""The PyTorch port's ``experiment`` ablations against the JAX package on
the CPU (``slice_no_deform``, ``pointnet_no_local_mean`` and
``pointnet_no_elevate`` here; ``test_torch_attention_pool.py`` holds the
other three): the offline forward on both ``precompute`` values in bf16
and float32, the plain and incremental streaming entry points of
``pointnet_no_local_mean`` (whose distribute keeps raw positions), and
the lattice build and the per-frame distribute without the local mean.
``test_torch_ablation_modules.py`` holds the ``grad_step`` cases.

The configurations are the tiny ones of ``tests/test_model.py`` (pointnet
(8, 16), 16 start channels); an experiment that changes the pointnet's
reduced width runs behind the early fusion "none", as the JAX package's
own test has it (``tests/test_model.py:147-163``), the others behind the
flagship's gru-gru-aflow-gru.  Three dense frames of 120 points (of 128)
with both trims active.  JAX weights through ``params_from_jax``.
Tolerances are those of ``test_torch_configs.py``: integer structure
equal; bf16 log-probabilities within 0.1 with 99 % argmax agreement (top
two classes closer than 0.0125 count as agreeing); float32 within 1e-4;
``grad_step`` losses within 1e-2 and every gradient's cosine at least
0.99.  The structure is bit-equal; relative positions equal the JAX
package's to 1e-5 (sums in another order; without the local mean they
are the raw positions, bit-equal).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.ops import lattice_ops as jlo
from temporal_latticenet_tpu.ops import seq_lattice as jsl
from temporal_latticenet_tpu.ops import vertex_table as jvt
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.ops import lattice_ops as tlo
from temporal_latticenet_tpu_torch.ops import seq_lattice as tsl
from temporal_latticenet_tpu_torch.ops import vertex_table as tvt
from temporal_latticenet_tpu_torch.train import engine

from .test_torch_configs import (F32_ATOL, TINY, _agree_bf16, _clouds,
                                 _jax_forward, _jparams,
                                 _one_torch_thread, _port, _same_structure)
from .test_torch_per_frame_route import RT_TRIM
from .test_torch_seq_lattice import _compare_lattice, _frames

# the experiments whose reduced width differs from the early fusion's
WIDTH_CHANGING = ("pointnet_no_elevate", "pointnet_no_elevate_no_local_mean",
                  "splat", "attention_pool")
FLAGSHIP = ("gru", "gru", "aflow", "gru")
EARLY_NONE = ("none", "gru", "aflow", "gru")
MAX_NEW = 512


def experiment_kw(experiment: str) -> dict:
    return dict(TINY, experiment=experiment,
                rnn_modules=(EARLY_NONE if experiment in WIDTH_CHANGING
                             else FLAGSHIP))


@functools.lru_cache(maxsize=None)
def experiment_case(experiment: str):
    """The experiment's configuration, runtimes, data and JAX parameters
    (one tree for bf16 and float32), built once per experiment."""
    kw = experiment_kw(experiment)
    jrt = JRuntimeConfig(**RT_TRIM, batched_pointnet=True)
    data = _clouds(3, 128, 120, 1.0, 1)
    jparams = _jparams(JModelConfig(**kw), jrt,
                       tuple(a[0] for a in (data[0], data[1], data[3])))
    return dict(kw=kw, jrt=jrt, rt=RuntimeConfig(**RT_TRIM), data=data,
                jparams=jparams)


def check_forward(experiment: str, compute_dtype: str):
    """Both ``precompute`` values of the port against the JAX package's
    offline forward (the experiment forces its non-batched route)."""
    case = experiment_case(experiment)
    kw = dict(case["kw"], compute_dtype=compute_dtype)
    pos, val, _, mask = case["data"]
    want, jaux = _jax_forward(case["jparams"], JModelConfig(**kw),
                              case["jrt"], (pos, val, mask))
    cfg, rt = ModelConfig(**kw), case["rt"]
    assert not engine.batched_pointnet(cfg, rt)
    model = _port(case["jparams"], cfg, rt)
    valid = mask[-1]
    for precompute in (True, False):
        got, _, aux = engine.make_sequence_forward(
            model, cfg, rt, precompute=precompute)(pos, val, mask)
        _same_structure(aux, jaux)
        assert not bool(aux["vertex_overflow"])
        if compute_dtype == "bfloat16":
            _agree_bf16(got, want, valid)
        else:
            assert np.isfinite(got.numpy()[valid]).all()
            np.testing.assert_allclose(got.numpy()[valid], want[valid],
                                       rtol=0, atol=F32_ATOL)


def check_streaming(experiment: str):
    """The plain and the incremental streaming entry points against the
    JAX package's, in bf16: structure equal, log-probabilities within the
    bf16 tolerance."""
    case = experiment_case(experiment)
    pos, val, _, mask = case["data"]
    jcfg, cfg = JModelConfig(**case["kw"]), ModelConfig(**case["kw"])
    jrt, rt = JRuntimeConfig(**RT_TRIM), case["rt"]
    jp = {"params": case["jparams"]}
    jm = JLNNSeq(jcfg, jrt)
    model = _port(case["jparams"], cfg, rt)
    n = len(pos)
    frames = [tuple(jnp.asarray(a[t]) for a in (pos, val, mask))
              for t in range(n)]

    ns, step, final = jengine.make_streaming_inference(jm, jcfg, jrt)
    s = ns()
    for f in frames[:-1]:
        s = step(jp, *f, s)
    want = final(jp, *frames[-1], s)
    new_fn, step_full, step_inc, final_inc = \
        jengine.make_streaming_inference_incremental(jm, jcfg, jrt, MAX_NEW)
    s, fs = new_fn()
    for t, f in enumerate(frames[:-1]):
        s, fs = (step_full if t == 0 else step_inc)(jp, *f, s, fs)
    want_inc = final_inc(jp, *frames[-1], s, fs)
    assert not bool(want_inc[3].overflowed)

    ns, step, final = engine.make_streaming_inference(model, cfg, rt)
    s = ns()
    for t in range(n - 1):
        s = step(pos[t], val[t], mask[t], s)
    got = final(pos[-1], val[-1], mask[-1], s)
    new_fn, step_full, step_inc, final_inc = \
        engine.make_streaming_inference_incremental(model, cfg, rt, MAX_NEW)
    s, fs = new_fn()
    for t in range(n - 1):
        s, fs = (step_full if t == 0 else step_inc)(pos[t], val[t], mask[t],
                                                   s, fs)
    got_inc = final_inc(pos[-1], val[-1], mask[-1], s, fs)
    assert not bool(got_inc[3].overflowed)

    for g, w in ((got, want), (got_inc, want_inc)):
        assert [int(tb.count) for tb in g[2].tables] == \
            [int(tb.count) for tb in w[2].tables]
        _same_structure(g[-1], w[-1])
        _agree_bf16(g[0], np.asarray(w[0]), mask[-1])


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("experiment", [
    "slice_no_deform", "pointnet_no_local_mean", "pointnet_no_elevate"])
def test_experiment_forward_matches_jax(experiment, compute_dtype):
    check_forward(experiment, compute_dtype)


def test_no_local_mean_streaming_matches_jax():
    check_streaming("pointnet_no_local_mean")


@pytest.mark.parametrize("caps", [(8192, 6144, 4096), (2048, 1024, 512)])
def test_sequence_lattice_without_local_mean_equals_jax(caps):
    """The no-local-mean build: level 0 through the plain birth union
    (keys, births, row indices and counts bit-equal, also saturated), raw
    positions, no ``nr_points`` or ``sorted_pn``, and no K3 (its plain
    version is never called)."""
    pos, _, _, mask = _frames(4)
    build = jax.jit(functools.partial(
        jsl.build_sequence_lattice, sigma=0.5, capacities=caps,
        nr_downsamples=2, subtract_local_mean=False))
    jl = build(jnp.asarray(pos), jnp.asarray(mask))
    calls = []
    orig = tsl.seg_sum_tails
    tsl.seg_sum_tails = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        tl = tsl.build_sequence_lattice(torch.from_numpy(pos),
                                        torch.from_numpy(mask), 0.5, caps, 2,
                                        subtract_local_mean=False)
    finally:
        tsl.seg_sum_tails = orig
    assert not calls
    assert tl.nr_points is None and tl.sorted_pn is None
    _compare_lattice(jl, tl)
    rows = torch.from_numpy(pos).repeat_interleave(4, dim=1) \
        * tl.row_valid[..., None]
    assert torch.equal(tl.row_rel_pos, rows)


@pytest.mark.parametrize("subtract_local_mean", [False, True])
def test_distribute_local_mean_flag_matches_jax(subtract_local_mean):
    """The per-frame distribute onto a carried table, two frames, with and
    without the local mean."""
    pos, _, _, mask = _frames(2, p=512, seed=3)
    jt, tt = jvt.make_table(4096, 3), tvt.make_table(4096, "cpu")
    for t in range(2):
        jt, jd = jlo.distribute(jt, jnp.asarray(pos[t]), jnp.asarray(mask[t]),
                                0.5, subtract_local_mean=subtract_local_mean)
        tt, td = tlo.distribute(tt, torch.from_numpy(pos[t]),
                                torch.from_numpy(mask[t]), 0.5,
                                subtract_local_mean=subtract_local_mean)
        np.testing.assert_array_equal(td.row_vertex.numpy(),
                                      np.asarray(jd.row_vertex))
        np.testing.assert_array_equal(td.row_valid.numpy(),
                                      np.asarray(jd.row_valid))
        np.testing.assert_allclose(td.row_rel_pos.numpy(),
                                   np.asarray(jd.row_rel_pos), rtol=0,
                                   atol=1e-5 if subtract_local_mean else 0)
