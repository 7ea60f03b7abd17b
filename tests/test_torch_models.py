"""Blocks, fusions and the batched pointnet of the PyTorch port against the
JAX package's flax modules, with the JAX weights carried across through
``train.convert.params_from_jax``.

The blocks run in float32 (the point is the algorithm; products differ
only in summation order: rtol/atol 1e-4), plus one ResNet block and the
pointnet in the flagship's bf16 (operands rounded to bf16 round alike, but
a float32 sum that differs in its last bit can round to the neighbouring
bf16 value downstream: held to 2e-2).
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
from temporal_latticenet_tpu.models import blocks as jb
from temporal_latticenet_tpu.models import fusion as jf
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.models.pointnet import PointNetSeq as JPointNet
from temporal_latticenet_tpu.ops import lattice_ops as jlo
from temporal_latticenet_tpu.ops import seq_lattice as jsl
from temporal_latticenet_tpu_torch.config import ModelConfig
from temporal_latticenet_tpu_torch.models import blocks as tb
from temporal_latticenet_tpu_torch.models import fusion as tf
from temporal_latticenet_tpu_torch.models.pointnet import PointNetSeq
from temporal_latticenet_tpu_torch.ops import lattice_ops as tlo
from temporal_latticenet_tpu_torch.ops import seq_lattice as tsl
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_torch_configs import _one_torch_thread  # noqa: F401

SIGMA = 0.5
CAPS = (8192, 6144, 4096)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jparams():
    """Flagship params of the JAX package (tiny-geometry init)."""
    cfg = JModelConfig()
    tiny = JRuntimeConfig(max_points=64, capacity_level0=256,
                          capacity_decay=0.5, min_capacity=64, sigma=0.6)
    rng = np.random.default_rng(0)
    p = rng.standard_normal((64, 3)).astype(np.float32) * 5
    init = jax.jit(lambda k, p_, v_, m_, s: JLNNSeq(cfg, tiny).init(
        k, p_, v_, m_, s, final=True))
    var = init(jax.random.PRNGKey(0), jnp.asarray(p), jnp.ones((64, 1)),
               jnp.ones((64,), bool), j_init_state(cfg, tiny))
    return jax.tree_util.tree_map(np.asarray, var["params"])


@pytest.fixture(scope="module")
def lattice():
    rng = np.random.default_rng(0)
    pos, val, _, mask = lidar_sequence(rng, frames=4, max_points=1024, n_az=16)
    tl = tsl.build_sequence_lattice(torch.from_numpy(pos),
                                    torch.from_numpy(mask), SIGMA, CAPS, 2,
                                    pn_values=torch.from_numpy(val),
                                    want_row_rel=False)
    return tl, pos, val, mask


def _load(module, jparams, top, prefix, cfg=None):
    """Port the JAX sub-tree ``jparams[top]`` into ``module``."""
    sd = params_from_jax({top: jparams[top]}, cfg or ModelConfig())
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sub, strict=True)
    return module


def _nbr(tl, level, t=3):
    n = tl.frame_nbr(level, t)
    return (jlo.NeighborTable(idx=jnp.asarray(n.idx.numpy().astype(np.int32)),
                              found=jnp.asarray(n.found.numpy())), n)


def _link(tl, l):
    k = tl.links[l]
    to = {f: getattr(k, f) for f in ("corner_idx", "corner_bary", "sorted_src",
                                     "sorted_w", "sorted_dst", "tailpos",
                                     "tail_live")}
    arr = {f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                          else v.numpy()) for f, v in to.items()}
    return jlo.LevelLink(**arr), k


def _values(tl, level, c, seed, t=3):
    count = int(tl.levels[level].counts[t])
    cap = tl.levels[level].nbr_idx.shape[0]
    x = np.random.default_rng(seed).standard_normal((cap, c)).astype(np.float32)
    x[0] = 0
    x[count:] = 0
    return x, count


def _apply(module, variables, *args, **kw):
    """``module.apply`` as one jitted graph: run op by op, each of its
    operations compiled alone, which took most of this file's time on the
    CPU."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_resnet_block(jparams, lattice, dtype, tol):
    tl = lattice[0]
    top = "resnet_blocks_per_down_lvl_list_0_1"
    x, count = _values(tl, 0, 64, 1)
    jn, tn = _nbr(tl, 0)
    want = _apply(jb.ResnetBlock(64, (False, False), dtype=dtype),
                  {"params": jparams[top]}, jnp.asarray(x), jn,
                  jnp.int32(count))
    mod = _load(tb.ResnetBlock(64, (False, False), dtype), jparams, top,
                "resnet_blocks_per_down_lvl_list.0.1.")
    _close(mod(torch.from_numpy(x), tn, torch.tensor(count)), want, tol)


def test_bottleneck_block(jparams, lattice):
    tl = lattice[0]
    top = "resnet_blocks_bottleneck_1"
    x, count = _values(tl, 2, 256, 2)
    jn, tn = _nbr(tl, 2)
    want = _apply(jb.BottleneckBlock(256, (False,) * 3, dtype="float32"),
                  {"params": jparams[top]}, jnp.asarray(x), jn,
                  jnp.int32(count))
    mod = _load(tb.BottleneckBlock(256, (False,) * 3), jparams, top,
                "resnet_blocks_bottleneck.1.")
    _close(mod(torch.from_numpy(x), tn, torch.tensor(count)), want, F32)


def test_coarsen_and_finefy(jparams, lattice):
    tl = lattice[0]
    # coarsen level 0 -> 1 (K2 sum splat at C = 64)
    x, c0 = _values(tl, 0, 64, 3)
    c1 = int(tl.levels[1].counts[3])
    jlink, tlink = _link(tl, 0)
    jn1, tn1 = _nbr(tl, 1)
    want = _apply(jb.GnReluCoarsen(128, dtype="float32"),
                  {"params": jparams["coarsens_list_0"]}, jnp.asarray(x),
                  jnp.int32(c0), jlink, jn1, jnp.int32(c1))
    mod = _load(tb.GnReluCoarsen(64, 128), jparams, "coarsens_list_0",
                "coarsens_list.0.")
    _close(mod(torch.from_numpy(x), torch.tensor(c0), tlink, tn1,
               torch.tensor(c1)), want, F32)
    # finefy level 2 -> 1
    x2, c2 = _values(tl, 2, 256, 4)
    jlink1, tlink1 = _link(tl, 1)
    jn2, tn2 = _nbr(tl, 2)
    want = _apply(jb.GnReluFinefy(128, dtype="float32"),
                  {"params": jparams["finefy_list_0"]}, jnp.asarray(x2),
                  jnp.int32(c2), jn2, jlink1, jnp.int32(c1))
    mod = _load(tb.GnReluFinefy(256, 128), jparams, "finefy_list_0",
                "finefy_list.0.")
    _close(mod(torch.from_numpy(x2), torch.tensor(c2), tn2, tlink1,
               torch.tensor(c1)), want, F32)


def test_deform_slice(jparams, lattice):
    tl = lattice[0]
    x, _ = _values(tl, 0, 192, 5)
    pv, pb = tl.point_vertex[3], tl.point_bary[3]
    params = dict(jparams["slice_fast_cuda"])
    # a nonzero deform head, so the delta path is exercised
    rng = np.random.default_rng(6)
    params["deform_kernel"] = rng.standard_normal(
        params["deform_kernel"].shape).astype(np.float32) * 0.01
    want = _apply(jb.DeformSlice(26), {"params": params}, jnp.asarray(x),
                  jnp.asarray(pv.numpy().astype(np.int32)),
                  jnp.asarray(pb.numpy()))
    mod = _load(tb.DeformSlice(192, 26), {"slice_fast_cuda": params},
                "slice_fast_cuda", "slice_fast_cuda.")
    _close(mod(torch.from_numpy(x), pv, pb), want, F32)
    # the plain barycentric slice-back
    want = jax.jit(jlo.slice_gather)(
        jnp.asarray(x), jnp.asarray(pv.numpy().astype(np.int32)),
        jnp.asarray(pb.numpy()))
    _close(tlo.slice_gather(torch.from_numpy(x), pv, pb), want, F32)


@pytest.mark.parametrize("is_first", [False, True])
def test_gru_fusion(jparams, lattice, is_first):
    tl = lattice[0]
    top = "recurrent_fusion_modules_0"
    lv, count = _values(tl, 0, 64, 7)
    h, prev = _values(tl, 0, 64, 8, t=2)
    want, _ = _apply(jf.GRUFusion(64), {"params": jparams[top]},
                     jnp.asarray(lv), jnp.asarray(h), jnp.int32(prev),
                     jnp.int32(count), jnp.asarray(is_first))
    mod = _load(tf.GRUFusion(64, 64), jparams, top,
                "recurrent_fusion_modules.0.")
    got, _ = mod(torch.from_numpy(lv), torch.from_numpy(h), torch.tensor(prev),
                 torch.tensor(count), is_first)
    _close(got, want, F32)


def test_aflow_fusion(jparams, lattice):
    tl = lattice[0]
    top = "recurrent_fusion_modules_1"
    lv, count = _values(tl, 2, 256, 9)
    h, prev = _values(tl, 2, 256, 10, t=2)
    jn, tn = _nbr(tl, 2)
    want, _ = _apply(jf.AFlowFusion(256), {"params": jparams[top]},
                     jnp.asarray(lv), jnp.asarray(h), jnp.int32(prev),
                     jnp.int32(count), jnp.asarray(False), jn,
                     mutable=["aux"])[0]
    mod = _load(tf.AFlowFusion(256), jparams, top,
                "recurrent_fusion_modules.1.")
    got, _ = mod(torch.from_numpy(lv), torch.from_numpy(h), torch.tensor(prev),
                 torch.tensor(count), False, tn)
    _close(got, want, F32)


def test_pointnet_reduce_sorted_and_fuse(jparams, lattice):
    tl, pos, val, mask = lattice
    cfg = JModelConfig()
    jl = jax.jit(lambda p_, m_, v_: jsl.build_sequence_lattice(
        p_, m_, SIGMA, CAPS, 2, pn_values=v_, want_row_rel=False))(
        jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(val))
    jpn = JPointNet(cfg)
    want = _apply(jpn, {"params": jparams["point_net_seq"]},
                  None, None, None, None, None, None, None,
                  sorted_batch=(jl.sorted_pn, jnp.asarray(val),
                                jl.row_bary, jl.nr_points))
    mod = _load(PointNetSeq(ModelConfig()), jparams, "point_net_seq",
                "point_net_seq.")
    # the reduced tensor carries the MLP's gradient (straight-through max)
    got = mod.reduce_sorted(tl.sorted_pn, torch.from_numpy(val), tl.row_bary,
                            tl.nr_points)
    assert got.requires_grad
    got = got.detach()
    _close(got, want, BF16)
    # nearly every maximum is bit-equal: the bf16 MLP rounds alike
    assert np.mean(got.numpy() == np.asarray(want)) > 0.99

    # early GRU fusion + the first lattice conv of frame 1
    jn, tn = _nbr(tl, 0, t=1)
    c1, c0 = int(tl.levels[0].counts[1]), int(tl.levels[0].counts[0])
    h = np.array(want[0])
    red = np.array(want[1])
    jout, _ = _apply(jpn, {"params": jparams["point_net_seq"]}, None, None,
                     jn, jnp.int32(c1), jnp.asarray(h), jnp.int32(c0),
                     jnp.asarray(False), pre_reduced=jnp.asarray(red))
    tout, _ = mod.fuse_and_conv(torch.from_numpy(red), tn, torch.tensor(c1),
                                torch.from_numpy(h), torch.tensor(c0), False)
    _close(tout, jout, BF16)
