"""The PyTorch port's checkpoints: ``checkpoint_name`` against the JAX
package's, save / load / resume exactness of the ``.ckpt`` files, and the
reference ``.pt`` route: a state_dict written by the JAX package's
``torch_convert.export_state_dict`` (and its nesting variants) loads
strictly and equals ``params_from_jax``; a bad file fails with a report
for each key.

The JAX parameter trees come from ``jax.eval_shape`` of the model's init
(shapes only, nothing compiled) filled with seeded values."""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.train import checkpoint as jckpt
from temporal_latticenet_tpu.train import torch_convert as tc
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.data.kitti import pad_frame
from temporal_latticenet_tpu_torch.train import checkpoint as ckpt
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

TINY = dict(nr_classes=8, frames_per_seq=2, pointnet_layers=(4, 8),
            pointnet_start_nr_channels=8, nr_downsamples=2,
            nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1,
            nr_blocks_up_stage=(1, 1))
KINDS = {
    "gru_aflow": dict(rnn_modules=("gru", "gru", "aflow", "gru")),
    # bottleneck blocks in the down and up stages, every other fusion kind
    "lstm_cga_linear": dict(rnn_modules=("lstm", "cga", "maxpool", "linear"),
                            nr_levels_down_with_normal_resnet=1,
                            nr_levels_up_with_normal_resnet=0),
}
RT = dict(max_points=64, capacity_level0=512, capacity_decay=1.0,
          min_capacity=256, sigma=0.6)


def _jax_params(kw, seed=0):
    """A flax parameter tree of the JAX model at ``kw``: shapes from
    ``jax.eval_shape`` of its init, values from a seeded generator."""
    cfg = JModelConfig(**kw)
    rt = JRuntimeConfig(**RT)
    model = JLNNSeq(cfg, rt)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((8, 3)), jnp.zeros((8, 1)), jnp.ones((8,), bool),
        j_init_state(cfg, rt), final=True), jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _save_pt(path, sd):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, str(path))


def _rename(sd, *pairs):
    out = {}
    for k, v in sd.items():
        for a, b in pairs:
            k = k.replace(a, b)
        out[k] = v
    return out


# the reference schema's nesting variants the converter resolves
VARIANTS = {
    "canonical": (),
    "gn": ((".gn.gn.", ".gn."),),
    "norm_convolution_classify": (
        (".gn.gn.", ".norm."), (".conv1.", ".gn_relu_conv1."),
        ("linear_clasify", "linear_classify")),
}


class _FixedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 3, 4, 5, 6)


@pytest.mark.parametrize("accumulate", [False, True])
def test_checkpoint_name_equal(monkeypatch, accumulate):
    monkeypatch.setattr(ckpt, "datetime", _FixedClock)
    monkeypatch.setattr(jckpt, "datetime", _FixedClock)
    for args in ((True, "semantickitti", "reflectance", 0.6,
                  ("gru", "gru", "aflow", "gru"), 4, 3, 7),
                 (False, "parislille", "xyz", 0.55, ("lstm",) * 4, 2, 1, 0)):
        name = ckpt.checkpoint_name(*args, accumulate_clouds=accumulate)
        assert name == jckpt.checkpoint_name(*args,
                                             accumulate_clouds=accumulate)
        assert name.startswith("04032026_0506_")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_export_state_dict_pt_loads_strictly(tmp_path, capsys, kind,
                                             variant):
    """A ``.pt`` from JAX ``export_state_dict`` (or one nesting variant of
    it) loads with ``strict=True`` through ``checkpoint.load``, equals
    ``params_from_jax``, starts at step 0 and says which pointnet
    semantics the weights run under."""
    kw = dict(TINY, **KINDS[kind])
    params = _jax_params(kw)
    sd = _rename(tc.export_state_dict(params, JModelConfig(**kw)),
                 *VARIANTS[variant])
    _save_pt(tmp_path / "ref.pt", sd)
    cfg = ModelConfig(**kw)
    model = engine.create_train_state(cfg, RuntimeConfig(**RT), 1e-3, 1e-3,
                                      device="cpu")[0]
    assert ckpt.load(str(tmp_path / "ref.pt"), model, cfg=cfg) == 0
    want = params_from_jax(params, cfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k
    assert "reference_bary_quirk=False" in capsys.readouterr().out


def _bad(sd, case):
    sd = dict(sd)
    if case == "unconsumed":
        sd["surprise_module.weight"] = np.zeros((2, 2), np.float32)
        sd["slice_fast_cuda.linear_other.weight"] = np.zeros((2,), np.float32)
        return sd, ValueError, ["surprise_module.weight",
                                "slice_fast_cuda.linear_other.weight",
                                "2 checkpoint key(s)"]
    if case == "missing":
        del sd["slice_fast_cuda.linear_clasify.bias"]
        del sd["point_net_seq.layers.1.bias"]
        return sd, ValueError, [
            "missing param: slice_fast_cuda.linear_clasify.bias",
            "missing param: point_net_seq.layers.1.bias", "2 problem(s)"]
    if case == "extra":
        sd["recurrent_fusion_modules.0.hidden_linear.bias"] = np.zeros(
            (3,), np.float32)
        sd["coarsens_list.1.conv.bias"] = np.zeros((5,), np.float32)
        return sd, ValueError, [
            "shape mismatch at recurrent_fusion_modules.0.hidden_linear.bias",
            "extra param not in model: coarsens_list.1.conv.bias"]
    if case == "transposed":
        for k in ("coarsens_list.0.conv.weight",
                  "slice_fast_cuda.linear_deltaW.weight"):
            sd[k] = np.ascontiguousarray(np.asarray(sd[k]).T)
        return sd, ValueError, [
            "coarsens_list.0.conv.weight", "linear_deltaW.weight",
            "(transposed?)", "2 problem(s)"]
    if case == "unresolvable":
        sd = {k: v for k, v in sd.items()
              if not k.startswith("coarsens_list.0.gn")}
        return sd, KeyError, ["coarsens_list.0", "coarsens_list.0.conv.weight"]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["unconsumed", "missing", "extra",
                                  "transposed", "unresolvable"])
def test_bad_pt_reports_each_key(tmp_path, case):
    """An unconsumed, missing, extra, transposed or unresolvable key fails
    the load, naming every key at fault; the model is left untouched."""
    kw = dict(TINY, **KINDS["gru_aflow"])
    sd = tc.export_state_dict(_jax_params(kw), JModelConfig(**kw))
    bad, exc, words = _bad(sd, case)
    _save_pt(tmp_path / "bad.pt", bad)
    cfg = ModelConfig(**kw)
    model = engine.create_train_state(cfg, RuntimeConfig(**RT), 1e-3, 1e-3,
                                      device="cpu")[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(exc) as ei:
        ckpt.load(str(tmp_path / "bad.pt"), model, cfg=cfg)
    for w in words:
        assert w in str(ei.value), (w, str(ei.value))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture
def one_thread():
    """torch's CPU work on one thread: on more threads the gathers'
    backward adds with atomics, and a step's gradients change from run to
    run (scripts/torch_cpu_determinism.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _batch(seed):
    """One padded 2-frame sequence of normal-distributed points."""
    rng = np.random.default_rng(seed)
    n = RT["max_points"] - 5
    frames = [pad_frame((rng.normal(size=(n, 3)) * 3).astype(np.float32),
                        rng.random((n, 1)).astype(np.float32),
                        rng.integers(0, TINY["nr_classes"], n),
                        RT["max_points"]) for _ in range(2)]
    return engine.SeqBatch.stack([frames], "cpu")


def test_save_load_resume_exact(tmp_path, one_thread):
    """Two steps, a save, two more: a fresh model and optimizer (another
    init seed) loaded from the file take the same two steps to the same
    losses and parameters, bit for bit, with amsgrad's max_exp_avg_sq and
    the step count restored."""
    cfg, rt = ModelConfig(**TINY, **KINDS["gru_aflow"]), RuntimeConfig(**RT)
    batches = [_batch(s) for s in range(4)]

    def trainer(seed):
        model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3,
                                                 seed=seed, device="cpu")
        return model, state, engine.make_train_step(model, cfg, rt)[0]

    model, state, step = trainer(0)
    for b in batches[:2]:
        state, _, _ = step(state, b, 0.7)
    path = str(tmp_path / "x.ckpt")
    ckpt.save(path, model, state.optimizer, state.step)
    losses = [float(step(state, b, 0.5)[2]["loss"]) for b in batches[2:]]

    model2, state2, step2 = trainer(1)
    state2.step = ckpt.load(path, model2, state2.optimizer)
    assert state2.step == 2
    opt_state = state2.optimizer.state_dict()
    assert all("max_exp_avg_sq" in s for s in opt_state["state"].values())
    assert all(g["base_lr"] == 1e-3 for g in opt_state["param_groups"])
    losses2 = [float(step2(state2, b, 0.5)[2]["loss"]) for b in batches[2:]]
    assert losses2 == losses
    assert state2.step == state.step == 4
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    o1, o2 = state.optimizer.state_dict(), state2.optimizer.state_dict()
    for i, s in o1["state"].items():
        for name, t in s.items():
            assert torch.equal(t, o2["state"][i][name]), (i, name)


def test_save_without_optimizer_loads_weights_only(tmp_path):
    """A file saved without optimizer state restores the weights and step;
    a ``.pt`` load without the model's cfg raises."""
    cfg, rt = ModelConfig(**TINY, **KINDS["gru_aflow"]), RuntimeConfig(**RT)
    model = engine.create_train_state(cfg, rt, 1e-3, 1e-3, device="cpu")[0]
    ckpt.save(str(tmp_path / "w.ckpt"), model, step=11)
    model2, state2 = engine.create_train_state(cfg, rt, 1e-3, 1e-3, seed=1,
                                               device="cpu")
    assert ckpt.load(str(tmp_path / "w.ckpt"), model2, state2.optimizer) == 11
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert state2.optimizer.state_dict()["state"] == {}
    with pytest.raises(ValueError, match="cfg"):
        ckpt.load(str(tmp_path / "x.pt"), model2)
