"""The PyTorch port's flagship offline sequence forward against the JAX
package's, plus the port's ground rules: the weight converter's schema, no
import of JAX or the JAX package, and CUDA as the default device.

The forward runs at a small geometry (4 frames of 1024 padded points, all
three trims active) with the JAX weights carried through
``params_from_jax``.  Tolerance: the lattice structure is identical (sigma
0.5 scales bit-identically in both packages), and both sides round the
same operands to bf16 and accumulate in float32; the float32 sums differ
only in order, and a last-bit difference can flip a later bf16 rounding,
which then propagates through 19 lattice convolutions.  Measured maximum
|d log p| on the valid points is about 2e-2; the test holds it to 0.1 and
the argmax to 99% agreement.
"""

import ast
import dataclasses
import functools
from pathlib import Path

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
from temporal_latticenet_tpu.train.torch_convert import export_state_dict
from temporal_latticenet_tpu_torch.config import (VALID_EXPERIMENTS,
                                                  ModelConfig, RuntimeConfig)
from temporal_latticenet_tpu_torch.models.fusion import make_fusion
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.train.convert import params_from_jax
from temporal_latticenet_tpu_torch.train.engine import (
    make_sequence_forward, make_streaming_inference_batched)

from .test_torch_configs import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
P = 1024
RT = dict(max_points=P, capacity_level0=8192, capacity_decay=0.5,
          min_capacity=5120, sigma=0.5, trim_capacity_level0=5120,
          final_capacity_level0=6656)


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


def test_flagship_sequence_forward_matches_jax(jparams):
    pos, val, _, mask = lidar_sequence(np.random.default_rng(0), frames=4,
                                       max_points=P, n_az=P // 64)
    jcfg, jrt = JModelConfig(), JRuntimeConfig(**RT)
    fwd = jax.jit(functools.partial(
        jengine.make_sequence_forward(JLNNSeq(jcfg, jrt), jcfg, jrt),
        {"params": jparams}))
    jlogp, _, jaux = fwd(jnp.asarray(pos), jnp.asarray(val), jnp.asarray(mask))

    cfg, rt = ModelConfig(), RuntimeConfig(**RT)
    model = LNNSeq(cfg, rt, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg), strict=True)
    tlogp, _, taux = make_sequence_forward(model, cfg, rt)(pos, val, mask)

    # the trims are active and sized so that nothing overflows
    assert rt.trim_capacities(2)[0] < rt.capacities(2)[0]
    assert rt.final_capacities(2)[0] < rt.capacities(2)[0]
    assert not bool(taux["trim_overflow"]) and not bool(jaux["trim_overflow"])
    np.testing.assert_array_equal(taux["occupancy"].numpy(),
                                  np.asarray(jaux["occupancy"]))
    np.testing.assert_array_equal(taux["point_vertex"].numpy(),
                                  np.asarray(jaux["point_vertex"]))

    valid = mask[-1]
    jl, tl = np.asarray(jlogp)[valid], tlogp.numpy()[valid]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(np.exp(tl).sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=0.1)
    assert np.mean(tl.argmax(-1) == jl.argmax(-1)) > 0.99


def test_params_from_jax_matches_export_schema(jparams):
    """Same keys and shapes as the JAX package's exporter, and the port's
    model takes them with ``strict=True``."""
    cfg = ModelConfig()
    want = export_state_dict(jparams, JModelConfig())
    got = params_from_jax(jparams, cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = LNNSeq(cfg, RuntimeConfig(**RT), device="cpu")
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)


def _port_sources():
    pkg = ROOT / "temporal_latticenet_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    forbidden = ("jax", "jaxlib", "flax", "temporal_latticenet_tpu")
    files = _port_sources()
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in forbidden, (path, name)


def test_default_device_is_cuda(monkeypatch):
    """With no device given and no CUDA, the entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LNNSeq(ModelConfig(), RuntimeConfig(**RT))
    with pytest.raises(RuntimeError, match="CUDA"):
        LNNSeq(ModelConfig(), RuntimeConfig(**RT), device="cuda")


def test_unported_paths_raise():
    """A mesh that is not a ``parallel.mesh.Mesh`` raises a TypeError (the
    streams over ranks are tests/test_torch_parallel.py's).  Every
    experiment builds its model and both forwards; one that
    changes the pointnet's reduced width behind an early GRU raises a
    ValueError at construction (the JAX package cannot run it either).  The
    fusion kinds, the non-batched route and float32 streaming run."""
    cfg, rt = ModelConfig(), RuntimeConfig(**RT)
    model = LNNSeq(cfg, rt, device="cpu")
    with pytest.raises(TypeError):
        make_streaming_inference_batched(model, cfg, rt, mesh=object())
    width_changing = ("pointnet_no_elevate",
                      "pointnet_no_elevate_no_local_mean", "splat",
                      "attention_pool")
    for exp in VALID_EXPERIMENTS:
        xcfg = dataclasses.replace(cfg, experiment=exp)
        if exp in width_changing:
            with pytest.raises(ValueError, match="early"):
                LNNSeq(xcfg, rt, device="cpu")
            xcfg = dataclasses.replace(
                xcfg, rnn_modules=("none",) + cfg.rnn_modules[1:])
        xmodel = LNNSeq(xcfg, rt, device="cpu")
        for precompute in (True, False):
            assert callable(make_sequence_forward(xmodel, xcfg, rt,
                                                  precompute=precompute))
    make_sequence_forward(model, cfg,
                          dataclasses.replace(rt, batched_pointnet=False))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    make_sequence_forward(model, f32, rt, precompute=False)
    for kind in ("lstm", "cga", "maxpool", "linear"):
        assert make_fusion(kind, 64, cfg) is not None
