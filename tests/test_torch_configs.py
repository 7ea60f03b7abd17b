"""The PyTorch port's remaining model configurations against the JAX
package on the CPU: the LSTM, CGA, MaxPool and Linear fusions alone and in
one model (offline forward, streaming forward, one ``grad_step``), the
weight schema of every fusion kind and of ``sequence_learning=False``, and
BASELINE configs 1-3.  ``test_torch_per_frame_route.py`` holds the
non-batched pointnet route, the per-frame maxima and the deform slice's
gather backward with the helpers of this file.

Tiny widths (the configurations of ``tests/test_model.py`` and
``tests/test_baseline_configs.py``: pointnet (8, 16), 16 start channels, one
block per stage), 96-128 padded points per frame, capacities 1024/512/256;
JAX weights come through ``params_from_jax``.  Tolerances, as elsewhere in
the port's tests: integer structure equal; the bf16 network's
log-probabilities within 0.1 with at least 99 % argmax agreement (operands
round alike, float32 sums differ in order and can flip a later bf16
rounding); float32 networks within 1e-4; single fusion modules within 2e-2;
``grad_step`` losses within 1e-2 and every gradient's cosine at least 0.99.

A point whose two top classes are closer in the JAX package's
log-probabilities than ``TIE_MARGIN`` is a tie that the bf16 noise may order
either way, and counts as agreeing: with 80 valid points one such flip would
otherwise be a 1.25 % disagreement.  The margin is fixed from the measured
noise: twice the largest difference at BASELINE config 3 (0.0062), the one
configuration here whose argmax flipped (classes 0.0004 apart; its float32
forward agrees to 2e-6); the largest difference over every bf16 comparison
in these files was 0.0089 (lstm-maxpool-cga-linear).  Each JAX function is compiled once per
configuration; the gradients are taken without rematerialisation (the
flagship's full remat is tested in ``test_torch_train.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import fusion as jf
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu.train import optim as joptim
from temporal_latticenet_tpu.train.torch_convert import export_state_dict
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models import fusion as tf
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_baseline_configs import RT as BASELINE_RT
from .test_baseline_configs import _cloud, _small

LOGP_ATOL = 0.1
ARGMAX_AGREE = 0.99
TIE_MARGIN = 0.0125
F32_ATOL = 1e-4
MODULE = dict(rtol=2e-2, atol=2e-2)
LOSS_ATOL = 1e-2
GRAD_COSINE = 0.99

TINY = dict(nr_classes=5, pointnet_layers=(8, 16),
            pointnet_start_nr_channels=16, nr_blocks_down_stage=(1, 1, 1),
            nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1, 1),
            frames_per_seq=3)
ALL_KINDS = ("lstm", "maxpool", "cga", "linear")   # tests/test_model.py:54
RT = dict(max_points=96, capacity_level0=1024, capacity_decay=0.5,
          min_capacity=256, sigma=0.6, remat_mode="none")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for a test file's small tensors: beside the
    suite's other workers an OpenMP team of eight waits on its slowest
    thread at every operation (a tiny training step took 13.7 s on eight
    threads, 0.35 s on one).  Other files import it; being autouse and
    module-scoped, it then pins each of them alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(t, p, n, spread, seed):
    """``t`` frames of ``n`` points (of ``p`` padded) drifting by 0.3 a
    frame, with values and labels in [1, 5)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 3)).astype(np.float32) * spread
    pos = np.zeros((t, p, 3), np.float32)
    val = np.zeros((t, p, 1), np.float32)
    lab = np.zeros((t, p), np.int32)
    mask = np.zeros((t, p), bool)
    for i in range(t):
        pos[i, :n] = base + 0.3 * i + rng.normal(size=(n, 3)) * 0.05
        val[i, :n] = rng.random((n, 1))
        lab[i, :n] = 1 + (pos[i, :n, 0] > 0) + 2 * (pos[i, :n, 2] > 0)
        mask[i, :n] = True
    return pos, val, lab, mask


def _jparams(jcfg, jrt, frame):
    """The JAX package's parameters of ``jcfg`` (initialised on one frame)."""
    model = JLNNSeq(jcfg, jrt)
    var = jax.jit(lambda k: model.init(
        k, *(jnp.asarray(a) for a in frame), j_init_state(jcfg, jrt),
        final=True))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, var["params"])


@functools.lru_cache(maxsize=None)
def _jax_forward_fn(jcfg, jrt, precompute):
    """The JAX package's sequence forward, jitted once per configuration."""
    fwd = jengine.make_sequence_forward(JLNNSeq(jcfg, jrt), jcfg, jrt,
                                        precompute=precompute)
    return jax.jit(lambda params, *data: fwd({"params": params}, *data))


def _port(jparams, cfg, rt):
    model = LNNSeq(cfg, rt, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg), strict=True)
    return model.eval()


def _jax_forward(jparams, jcfg, jrt, data, precompute=True):
    logp, _, aux = _jax_forward_fn(jcfg, jrt, precompute)(
        jparams, *(jnp.asarray(a) for a in data))
    return np.asarray(logp), aux


def _agree_bf16(got, want, valid):
    g, w = got.numpy()[valid], want[valid]
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=0, atol=LOGP_ATOL)
    ga, wa = g.argmax(-1), w.argmax(-1)
    rows = np.arange(len(w))
    tie = w[rows, wa] - w[rows, ga] < TIE_MARGIN
    assert np.mean((ga == wa) | tie) >= ARGMAX_AGREE


def _same_structure(taux, jaux):
    for k in ("occupancy", "point_vertex"):
        np.testing.assert_array_equal(taux[k].numpy(),
                                      np.asarray(jaux[k]).astype(np.int64))


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b / (na * nb))


def _grad_step_matches(jparams, jcfg, jrt, cfg, rt, batch, zero_grads=()):
    """``grad_step`` of the port against the JAX package's.  ``zero_grads``
    names parameters whose gradient is zero in exact arithmetic (both sides
    hold rounding noise, whose cosine means nothing): each must be below
    1e-6 of the largest gradient entry on both sides instead."""
    tx = joptim.make_optimizer(1e-3, 1e-3)
    step, _ = jengine.make_train_step(JLNNSeq(jcfg, jrt), jcfg, jrt, tx)
    jloss, jgrads = step.grad_step(
        {"params": jparams},
        jengine.SeqBatch(*(jnp.asarray(a)[None] for a in batch)),
        jnp.int32(0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jgrads["params"]), cfg)
    model, _ = engine.create_train_state(cfg, rt, 1e-3, 1e-3, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg), strict=True)
    train_step, _ = engine.make_train_step(model, cfg, rt)
    loss, grads = train_step.grad_step(
        engine.SeqBatch(*(a[None] for a in batch)))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert sorted(grads) == sorted(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in grads.items():
        g, w = g.numpy(), want[name].numpy()
        assert np.isfinite(g).all(), name
        if name in zero_grads:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * scale, name
            continue
        assert _cosine(g, w) >= GRAD_COSINE, (name, _cosine(g, w))


# ---------------------------------------------------------------------------
# each fusion alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_first", [False, True])
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_fusion_matches_jax(kind, is_first):
    """One fusion module at the middle slot's width, with the hidden state
    of an earlier, smaller frame (new rows read the pad)."""
    c, cap, count, prev = 16, 512, 300, 200
    rng = np.random.default_rng(7)
    lv = rng.standard_normal((cap, c)).astype(np.float32)
    h = rng.standard_normal((cap, c)).astype(np.float32)
    lv[0], lv[count:], h[0], h[prev:] = 0, 0, 0, 0
    args = (jnp.asarray(lv), jnp.asarray(h), jnp.int32(prev),
            jnp.int32(count), jnp.asarray(is_first))
    jmod = jf.make_fusion(kind, c)
    variables = jmod.init(jax.random.PRNGKey(1), *args)
    want, want_h = jmod.apply(variables, *args)

    cfg = ModelConfig(rnn_modules=("gru", kind, "gru", "gru"))
    mod = tf.make_fusion(kind, c, cfg)
    prefix = "recurrent_fusion_modules.0."
    sd = params_from_jax(
        {"recurrent_fusion_modules_0": jax.tree_util.tree_map(
            np.asarray, variables.get("params", {}))}, cfg)
    mod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                        strict=True)
    got, got_h = mod(torch.from_numpy(lv), torch.from_numpy(h),
                     torch.tensor(prev), torch.tensor(count), is_first)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               **MODULE)
    if is_first:
        np.testing.assert_array_equal(got.detach().numpy(), lv)


# ---------------------------------------------------------------------------
# lstm-maxpool-cga-linear: every kind, and the early maxpool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kinds():
    cfg_kw = dict(TINY, rnn_modules=ALL_KINDS)
    jcfg, jrt = JModelConfig(**cfg_kw), JRuntimeConfig(**RT)
    data = _clouds(3, 96, 80, 2.0, 0)
    jparams = _jparams(jcfg, jrt, tuple(a[0] for a in
                                        (data[0], data[1], data[3])))
    return dict(jcfg=jcfg, jrt=jrt, cfg=ModelConfig(**cfg_kw),
                rt=RuntimeConfig(**RT), data=data, jparams=jparams)


@pytest.mark.parametrize("precompute", [True, False])
def test_all_fusion_kinds_forward_matches_jax(kinds, precompute):
    """The offline forward (precompute=True) and the streaming forward
    (precompute=False: frame by frame through the streaming entry points)
    against the JAX package's own."""
    pos, val, _, mask = kinds["data"]
    want, jaux = _jax_forward(kinds["jparams"], kinds["jcfg"], kinds["jrt"],
                              (pos, val, mask), precompute)
    model = _port(kinds["jparams"], kinds["cfg"], kinds["rt"])
    got, _, aux = engine.make_sequence_forward(
        model, kinds["cfg"], kinds["rt"], precompute=precompute)(pos, val,
                                                                mask)
    _same_structure(aux, jaux)
    assert not bool(aux["vertex_overflow"])
    _agree_bf16(got, want, mask[-1])


def test_all_fusion_kinds_grad_step_matches_jax(kinds):
    pos, val, lab, mask = kinds["data"]
    _grad_step_matches(kinds["jparams"], kinds["jcfg"], kinds["jrt"],
                       kinds["cfg"], kinds["rt"], (pos, val, lab, mask))


def test_params_from_jax_matches_export_schema_for_every_kind(kinds):
    """Same keys, shapes and values as the JAX package's exporter for every
    fusion kind, and for ``sequence_learning=False``; the port's model
    takes them with ``strict=True``."""
    single = dict(TINY, sequence_learning=False, frames_per_seq=1)
    frame = tuple(a[0] for a in (kinds["data"][0], kinds["data"][1],
                                 kinds["data"][3]))
    cases = [(kinds["jcfg"], kinds["cfg"], kinds["jparams"]),
             (JModelConfig(**single), ModelConfig(**single),
              _jparams(JModelConfig(**single), kinds["jrt"], frame))]
    for jcfg, cfg, jparams in cases:
        want = export_state_dict(jparams, jcfg)
        got = params_from_jax(jparams, cfg)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        model = LNNSeq(cfg, kinds["rt"], device="cpu")
        assert sorted(model.state_dict()) == sorted(want)
        model.load_state_dict(got, strict=True)


# ---------------------------------------------------------------------------
# BASELINE configs 1-3, built as tests/test_baseline_configs.py builds them
# ---------------------------------------------------------------------------

def _baseline_case(jcfg, frames, precompute=True):
    """One BASELINE config against the JAX package's offline forward
    (precompute=True) or its streaming forward (precompute=False)."""
    data = tuple(np.stack([np.asarray(f[i]) for f in frames])
                 for i in range(3))
    jparams = _jparams(jcfg, BASELINE_RT, tuple(a[0] for a in data))
    want, jaux = _jax_forward(jparams, jcfg, BASELINE_RT, data, precompute)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    rt = RuntimeConfig(**dataclasses.asdict(BASELINE_RT))
    got, _, aux = engine.make_sequence_forward(
        _port(jparams, cfg, rt), cfg, rt, precompute=precompute)(*data)
    _same_structure(aux, jaux)
    assert not bool(aux["vertex_overflow"])
    _agree_bf16(got, want, data[2][-1])


def test_baseline_config1_single_frame(rng):
    cfg = _small(sequence_learning=False, frames_per_seq=1,
                 rnn_modules=("gru", "gru", "gru", "gru"))
    _baseline_case(cfg, [_cloud(rng)])


def test_baseline_config1_streaming(rng):
    """``sequence_learning=False`` through the streaming entry points."""
    cfg = _small(sequence_learning=False, frames_per_seq=1,
                 rnn_modules=("gru", "gru", "gru", "gru"))
    _baseline_case(cfg, [_cloud(rng)], precompute=False)


def test_baseline_config2_accumulated_clouds(rng):
    cfg = _small(sequence_learning=False, frames_per_seq=1,
                 rnn_modules=("gru", "gru", "gru", "gru"))
    scans = [_cloud(rng, n=30, t=0.3 * i) for i in range(3)]
    pos = jnp.zeros((96, 3)).at[:90].set(
        jnp.concatenate([s[0][:30] for s in scans]))
    val = jnp.zeros((96, 1)).at[:90].set(
        jnp.concatenate([s[1][:30] for s in scans]))
    msk = jnp.zeros(96, bool).at[:90].set(True)
    _baseline_case(cfg, [(pos, val, msk)])


def test_baseline_config3_gru_fusion_frames3(rng):
    cfg = _small(sequence_learning=True, frames_per_seq=3,
                 rnn_modules=("gru", "gru", "gru", "gru"))
    _baseline_case(cfg, [_cloud(rng, t=0.3 * i) for i in range(3)])
