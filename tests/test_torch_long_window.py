"""The long window, ``frames_per_seq=8``, on the PyTorch port against the
JAX package, on the CPU: the counterpart of the JAX package's
``tests/test_train.py::test_long_window_frames8_offline_matches_streaming``.

At eight frames the trim capacities and the recurrence bite at depth,
where the rest of the suite runs three or four frames.  On the tiny
model with JAX weights through ``params_from_jax``, the port's offline
forward (with and without trimmed prefixes for frames 0..6) and its
streaming forward must agree with each other within the JAX package's own
bounds for the same comparisons, and each must match JAX's offline
log-probabilities within the bf16 tolerance of
``tests/test_torch_streaming.py`` (2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.train import engine, optim
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_torch_configs import _one_torch_thread  # noqa: F401

T = 8
BF16 = 2e-2          # tests/test_torch_streaming.py:53
STREAM_ATOL = 2e-3   # the JAX test's bound, streaming vs offline
TRIM_ATOL = 1e-2     # the JAX test's bound, trimmed vs untrimmed
TRIM_AGREE = 0.99
# the tiny model of tests/test_torch_streaming.py at eight frames
CFG = dict(nr_classes=5, pointnet_layers=(8, 16),
           pointnet_start_nr_channels=16, nr_blocks_down_stage=(1, 1, 1),
           nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1, 1),
           rnn_modules=("gru", "gru", "aflow", "gru"), frames_per_seq=T)
# the JAX test's runtime (one capacity at every level) and trims
RT = dict(max_points=128, capacity_level0=4096, capacity_decay=1.0,
          min_capacity=1024, sigma=0.6)
TRIMS = dict(trim_capacity_level0=3072, final_capacity_level0=3584)


@pytest.fixture(scope="module")
def window():
    """Eight frames of 100 points drifting by 0.3 per frame (the inputs of
    the JAX test's ``_frames``), the tiny model's JAX weights and JAX's
    offline log-probabilities."""
    rng = np.random.default_rng(0)
    pos = np.zeros((T, 128, 3), np.float32)
    val = np.zeros((T, 128, 1), np.float32)
    mask = np.zeros((T, 128), bool)
    for t in range(T):
        pos[t, :100] = rng.normal(size=(100, 3)).astype(np.float32) * 4 \
            + t * 0.3
        val[t, :100] = rng.random((100, 1)).astype(np.float32)
        mask[t, :100] = True
    jcfg, jrt = JModelConfig(**CFG), JRuntimeConfig(**RT)
    jmodel = JLNNSeq(jcfg, jrt)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(pos[0]), jnp.asarray(val[0]), jnp.asarray(mask[0]),
        j_init_state(jcfg, jrt), final=True))(jax.random.PRNGKey(0))
    params = {"params": params["params"]}
    # one jitted graph: run op by op, the same forward compiled each of
    # its operations alone and took 105 s of the file's 110 on the CPU
    fwd = jax.jit(jengine.make_sequence_forward(jmodel, jcfg, jrt,
                                                precompute=True))
    logp, _, aux = fwd(params, jnp.asarray(pos), jnp.asarray(val),
                       jnp.asarray(mask))
    return dict(pos=pos, val=val, mask=mask, jparams=params["params"],
                jlogp=np.asarray(logp),
                jpoint_vertex=np.asarray(aux["point_vertex"]))


def _port(window, rt_kw):
    cfg, rt = ModelConfig(**CFG), RuntimeConfig(**rt_kw)
    model = LNNSeq(cfg, rt, device="cpu")
    model.load_state_dict(params_from_jax(window["jparams"], cfg),
                          strict=True)
    return model.eval(), cfg, rt


def test_long_window_offline_trimmed_and_streaming_match_jax(window):
    P, V, M = window["pos"], window["val"], window["mask"]
    m = M[-1]
    model, cfg, rt = _port(window, RT)
    with torch.no_grad():
        logp_off, _, aux_off = engine.make_sequence_forward(
            model, cfg, rt, precompute=True)(P, V, M)
        new_state, step, final = engine.make_streaming_inference(model, cfg,
                                                                 rt)
        s = new_state()
        for t in range(T - 1):
            s = step(P[t], V[t], M[t], s)
        logp_st, _, s, aux_st = final(P[-1], V[-1], M[-1], s)
    assert s.t == T
    assert torch.equal(aux_st["point_vertex"], aux_off["point_vertex"])
    assert torch.equal(aux_st["occupancy"], aux_off["occupancy"])
    np.testing.assert_array_equal(aux_off["point_vertex"].numpy(),
                                  window["jpoint_vertex"].astype(np.int64))
    np.testing.assert_allclose(logp_st.numpy()[m], logp_off.numpy()[m],
                               rtol=0, atol=STREAM_ATOL)

    # frames 0..6 on trimmed row prefixes
    model_t, cfg_t, rt_t = _port(window, dict(RT, **TRIMS))
    with torch.no_grad():
        logp_trim, _, aux_t = engine.make_sequence_forward(
            model_t, cfg_t, rt_t, precompute=True)(P, V, M)
    assert not bool(aux_t["trim_overflow"])
    np.testing.assert_allclose(logp_trim.numpy()[m], logp_off.numpy()[m],
                               rtol=0, atol=TRIM_ATOL)
    agree = (logp_trim.numpy()[m].argmax(-1)
             == logp_off.numpy()[m].argmax(-1)).mean()
    assert agree > TRIM_AGREE, agree

    for logp in (logp_off, logp_st, logp_trim):
        np.testing.assert_allclose(logp.numpy()[m], window["jlogp"][m],
                                   rtol=0, atol=BF16)


def test_long_window_trains(window):
    """The BPTT step at depth 8 on the trimmed model: finite loss and
    gradient norm (the JAX test's last check)."""
    model, cfg, rt = _port(window, dict(RT, **TRIMS))
    model.train()
    state = engine.TrainState(optim.make_optimizer(model.parameters(), 1e-3,
                                                   1e-3))
    train_step, _ = engine.make_train_step(model, cfg, rt)
    labels = np.zeros((1, T, 128), np.int32)
    labels[:, :, :100] = 1
    batch = engine.SeqBatch(*(torch.as_tensor(a) for a in (
        window["pos"][None], window["val"][None], labels,
        window["mask"][None])))
    state, _, metrics = train_step(state, batch, 1.0)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
