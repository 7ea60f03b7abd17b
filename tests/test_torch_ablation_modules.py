"""The PyTorch port's ablation options beyond the forwards of
``test_torch_experiments.py``, on the CPU: ``grad_step`` against the JAX
package for ``attention_pool`` and ``pointnet_no_elevate``; the weight
schema of every experiment and of dropout through ``params_from_jax`` and
the ``.pt`` route of ``train/checkpoint.py``; the slice head's dropout in
the training step; ``apply_all_up_resnets`` against the JAX package; and
the small modules: the classic splat and slice, ``models/io_utils``.

The JAX parameter trees of the schema tests come from ``jax.eval_shape``
(nothing compiled) and are filled from a numpy seed; the JAX package's own
``export_state_dict`` cannot write these experiments (ROADMAP C-3), so the
port reads the numpy tree.  Tolerances: ``test_torch_experiments.py``; the
classic splat and slice within 1e-5 (float32 sums in other orders).
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.models import io_utils as jio
from temporal_latticenet_tpu.ops import lattice_ops as jlo
from temporal_latticenet_tpu_torch.config import (VALID_EXPERIMENTS,
                                                  ModelConfig, RuntimeConfig)
from temporal_latticenet_tpu_torch.models import io_utils as tio
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.ops import lattice_ops as tlo
from temporal_latticenet_tpu_torch.train import checkpoint as ckpt
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_torch_configs import (F32_ATOL, TINY, _agree_bf16, _clouds,
                                 _grad_step_matches, _jax_forward, _jparams,
                                 _port, _same_structure)
from .test_torch_experiments import (_one_torch_thread,  # noqa: F401
                                     experiment_case, experiment_kw)
from .test_torch_per_frame_route import RT_TRIM

CLASSIC_ATOL = 1e-5
DROPOUT = 0.2


# ---------------------------------------------------------------------------
# grad_step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experiment", ["attention_pool",
                                        "pointnet_no_elevate"])
def test_experiment_grad_step_matches_jax(experiment):
    """``attention_pool``: the gradients of gamma, pre_conv and the two
    GN-ReLU-1x1s over the point rows (the scores' bias adds one constant
    per channel to every row's score, which the per-vertex normalisation
    divides out: its gradient is zero); ``pointnet_no_elevate``: no
    pointnet MLP, the float32 rows through the argmax max."""
    case = experiment_case(experiment)
    _grad_step_matches(case["jparams"], JModelConfig(**case["kw"]),
                       case["jrt"], ModelConfig(**case["kw"]), case["rt"],
                       case["data"],
                       zero_grads=("point_net_seq.att_scores.conv.bias",))


# ---------------------------------------------------------------------------
# the weight schema of every experiment and of dropout
# ---------------------------------------------------------------------------

def _numpy_tree(kw, seed=0):
    """The JAX package's parameter tree of ``kw`` by ``jax.eval_shape``,
    filled from a numpy seed."""
    jcfg = JModelConfig(**kw)
    jrt = JRuntimeConfig(max_points=8, capacity_level0=64, capacity_decay=1.0,
                         min_capacity=64, sigma=0.6)
    shapes = jax.eval_shape(
        lambda k: JLNNSeq(jcfg, jrt).init(
            k, jnp.zeros((8, 3)), jnp.zeros((8, 1)), jnp.ones((8,), bool),
            j_init_state(jcfg, jrt), final=True),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


SCHEMAS = [dict(experiment=e) for e in VALID_EXPERIMENTS if e != "none"] \
    + [dict(experiment="none", dropout_last_layer=DROPOUT)]


@pytest.mark.parametrize("extra", SCHEMAS,
                         ids=[s["experiment"] if s["experiment"] != "none"
                              else "dropout" for s in SCHEMAS])
def test_weight_schema_round_trips(extra, tmp_path):
    """``params_from_jax`` of the numpy tree loads strictly and carries
    every value; the model's ``.pt`` loads strictly into a fresh model by
    ``checkpoint.load`` and gives every tensor back."""
    kw = dict(experiment_kw(extra["experiment"]), **extra)
    cfg, rt = ModelConfig(**kw), RuntimeConfig(**RT_TRIM)
    tree = _numpy_tree(kw)
    sd = params_from_jax(tree, cfg)
    model = LNNSeq(cfg, rt, device="cpu")
    ckpt.validate_converted(sd, model.state_dict())
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    pn = {k for k in sd if k.startswith("point_net_seq.")}
    exp = extra["experiment"]
    assert any(".layers." in k for k in pn) == (exp not in (
        "pointnet_no_elevate", "pointnet_no_elevate_no_local_mean", "splat"))
    assert ({"point_net_seq.gamma", "point_net_seq.pre_conv.weight",
             "point_net_seq.att_activ.gn.gn.weight",
             "point_net_seq.att_scores.conv.bias"} <= pn) \
        == (exp == "attention_pool")
    assert any("linear_deltaW" in k for k in sd) == (exp != "slice_no_deform")
    # the attention pool's 1x1 kernels transpose to torch's (out, in)
    if exp == "attention_pool":
        np.testing.assert_array_equal(
            sd["point_net_seq.pre_conv.weight"].numpy(),
            tree["point_net_seq"]["pre_conv_kernel"].T)

    path = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), path)
    fresh = LNNSeq(cfg, rt, device="cpu", seed=1)
    assert ckpt.load(path, fresh, cfg=cfg) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_width_changing_experiment_behind_an_early_fusion_raises():
    """The JAX package cannot run such a model either (its fusion's
    ``where`` fails on the shapes); the port says so at construction."""
    rt = RuntimeConfig(**RT_TRIM)
    for exp in ("pointnet_no_elevate", "pointnet_no_elevate_no_local_mean",
                "splat", "attention_pool"):
        for early in ("gru", "maxpool"):
            cfg = ModelConfig(**dict(TINY, experiment=exp,
                                     rnn_modules=(early, "gru", "aflow",
                                                  "gru")))
            with pytest.raises(ValueError, match="early"):
                LNNSeq(cfg, rt, device="cpu")


# ---------------------------------------------------------------------------
# dropout in the training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dropout_model():
    kw = dict(TINY, rnn_modules=("gru", "gru", "aflow", "gru"),
              dropout_last_layer=DROPOUT)
    data = _clouds(3, 128, 120, 1.0, 1)
    batch = engine.SeqBatch(*(a[None] for a in data))
    return ModelConfig(**kw), batch


def test_dropout_runs_in_the_training_step_only(dropout_model):
    """The training step drops about ``dropout_last_layer`` of the final
    frame's slice features, by a mask the step count seeds (the same step
    draws the same mask, so a resumed run does too); the evaluation and
    loss steps run without dropout and repeat exactly."""
    cfg, batch = dropout_model
    rt = RuntimeConfig(**RT_TRIM)
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3,
                                             device="cpu")
    train_step, eval_step = engine.make_train_step(model, cfg, rt)
    l0, g0 = train_step.grad_step(batch, 0)
    g0 = {k: v.clone() for k, v in g0.items()}
    l0b, g0b = train_step.grad_step(batch, 0)
    l1, _ = train_step.grad_step(batch, 1)
    assert float(l0) == float(l0b) and float(l0) != float(l1)
    for k in g0:
        assert torch.equal(g0[k], g0b[k]), k
    e1, m1 = eval_step(batch)
    e2, m2 = eval_step(batch)
    _, m3 = train_step.loss_step(batch)
    assert torch.equal(e1, e2)
    assert float(m1["loss"]) == float(m2["loss"]) == float(m3["loss"])
    assert float(m1["loss"]) not in (float(l0), float(l1))
    state, _, m = train_step(state, batch, 1.0)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    assert abs(float(m["dropped_share"]) - DROPOUT) <= 0.02


def test_dropout_mask_survives_full_remat(dropout_model):
    """Full remat recomputes the final frame in the backward; the dropout
    mask is drawn before the frame runs, so the gradients equal those
    taken without remat."""
    cfg, batch = dropout_model
    grads = []
    for remat in ("none", "full"):
        rt = RuntimeConfig(**dict(RT_TRIM, remat_mode=remat))
        model, _ = engine.create_train_state(cfg, rt, 1e-3, 1e-3,
                                             device="cpu")
        train_step, _ = engine.make_train_step(model, cfg, rt)
        loss, g = train_step.grad_step(batch, 3)
        grads.append((float(loss), {k: v.clone() for k, v in g.items()}))
    (la, ga), (lb, gb) = grads
    assert la == lb
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# apply_all_up_resnets against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_apply_all_up_resnets_matches_jax(compute_dtype):
    """The "intended" architecture: every up stage's resnet blocks run."""
    kw = dict(TINY, rnn_modules=("gru", "gru", "aflow", "gru"),
              apply_all_up_resnets=True, compute_dtype=compute_dtype)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jrt, rt = JRuntimeConfig(**RT_TRIM), RuntimeConfig(**RT_TRIM)
    pos, val, _, mask = _clouds(3, 128, 120, 1.0, 1)
    jparams = _jparams(JModelConfig(**dict(kw, compute_dtype="float32")),
                       jrt, (pos[0], val[0], mask[0]))
    assert "resnet_blocks_per_up_lvl_list_0_0" in jparams
    want, jaux = _jax_forward(jparams, jcfg, jrt, (pos, val, mask))
    model = _port(jparams, cfg, rt)
    assert "0" in model.resnet_blocks_per_up_lvl_list
    got, _, aux = engine.make_sequence_forward(model, cfg, rt)(pos, val, mask)
    _same_structure(aux, jaux)
    if compute_dtype == "bfloat16":
        _agree_bf16(got, want, mask[-1])
    else:
        np.testing.assert_allclose(got.numpy()[mask[-1]], want[mask[-1]],
                                   rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# the classic splat and slice; io_utils
# ---------------------------------------------------------------------------

def _classic_inputs(seed=6, cap=700, p=3000, c=5):
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, cap - 50, (p, 4))
    idx[rng.random(p) < 0.2] = 0                 # invalid points
    bary = np.where(idx > 0, rng.random((p, 4)), 0).astype(np.float32)
    values = rng.standard_normal((cap, c)).astype(np.float32)
    values[0] = 0                                # the mask_rows invariant
    pvals = rng.standard_normal((p, c)).astype(np.float32)
    return cap, idx, bary, values, pvals


def test_classic_splat_and_slice_match_jax_and_are_adjoint():
    cap, idx, bary, values, pvals = _classic_inputs()
    ji, jb = jnp.asarray(idx), jnp.asarray(bary)
    ti, tb = torch.from_numpy(idx), torch.from_numpy(bary)
    sliced = tlo.slice_classic(torch.from_numpy(values), ti, tb)
    splat = tlo.splat_classic(torch.from_numpy(pvals), ti, tb, cap)
    np.testing.assert_allclose(
        sliced.numpy(), np.asarray(jlo.slice_classic(jnp.asarray(values), ji,
                                                     jb)),
        rtol=0, atol=CLASSIC_ATOL)
    np.testing.assert_allclose(
        splat.numpy(), np.asarray(jlo.splat_classic(jnp.asarray(pvals), ji,
                                                    jb, cap)),
        rtol=0, atol=CLASSIC_ATOL)
    assert (splat[0] == 0).all() and (splat[-50:] == 0).all()
    # <slice(V), U> == <V, splat(U)>
    lhs = float((sliced.double() * torch.from_numpy(pvals).double()).sum())
    rhs = float((torch.from_numpy(values).double() * splat.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


POSITIONS_MODES = ("xyz", "xyz+rgb", "xyz+intensity")
VALUES_MODES = ("none", "intensity", "reflectance", "rgb", "rgb+height",
                "rgb+xyz", "height", "xyz")


def test_prepare_cloud_every_mode_matches_jax():
    rng = np.random.default_rng(9)
    n = 50
    cloud = dict(V=rng.standard_normal((n, 3)), C=rng.random((n, 3)),
                 I=rng.random((n, 1)), L_gt=rng.integers(0, 20, n))
    for pm in POSITIONS_MODES:
        for vm in VALUES_MODES:
            want = jio.prepare_cloud(jio.Cloud(**cloud), pm, vm)
            got = tio.prepare_cloud(tio.Cloud(**cloud), pm, vm)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype, (pm, vm)
                np.testing.assert_array_equal(a, b, err_msg=f"{pm} {vm}")
    assert tio.prepare_cloud(tio.Cloud(V=cloud["V"], I=cloud["I"]))[2] \
        is None
    with pytest.raises(ValueError):
        tio.prepare_cloud(tio.Cloud(**cloud), "uvw")
    with pytest.raises(ValueError):
        tio.prepare_cloud(tio.Cloud(**cloud), "xyz", "normals")


@pytest.mark.parametrize("experiment", ["none", "attention_pool"])
def test_summary_total_matches_jax(experiment):
    """The parameter total of the port's model equals the JAX package's
    for the same configuration, and every top-level module is listed."""
    kw = dataclasses.asdict(ModelConfig(experiment=experiment))
    if experiment == "attention_pool":
        kw["rnn_modules"] = ("none", "gru", "aflow", "gru")
    want = jio.summary(_numpy_tree(kw), file=io.StringIO())
    out = io.StringIO()
    model = LNNSeq(ModelConfig(**kw), RuntimeConfig(**RT_TRIM), device="cpu")
    assert tio.summary(model, file=out) == want
    text = out.getvalue()
    assert f"TOTAL: {want:,} params" in text
    assert "point_net_seq:" in text and "slice_fast_cuda:" in text
