"""The PyTorch port's ``pointnet_no_elevate_no_local_mean``, ``splat`` and
``attention_pool`` experiments against the JAX package on the CPU: the
offline forward on both ``precompute`` values in bf16 and float32, the
plain and incremental streaming entry points of ``attention_pool``, and
the pieces of those two reductions: ``segment_mean`` (with the invalid
bucket, row 0, of ``lattice_ops.segment_sum``), the GroupNorm and the
GN-ReLU-1x1 over the valid point rows (``mask=``), and the slice head's
dropout.  Configurations, data and tolerances: ``test_torch_experiments.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.models import blocks as jblocks
from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu_torch.models.blocks import DeformSlice, GnRelu1x1
from temporal_latticenet_tpu_torch.ops import segment as tseg

from .test_torch_experiments import (_one_torch_thread,  # noqa: F401
                                     check_forward, check_streaming)

MODULE_ATOL = 1e-5


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("experiment", [
    "pointnet_no_elevate_no_local_mean", "splat", "attention_pool"])
def test_experiment_forward_matches_jax(experiment, compute_dtype):
    check_forward(experiment, compute_dtype)


def test_attention_pool_streaming_matches_jax():
    check_streaming("attention_pool")


def test_segment_mean_matches_jax():
    """Means of the valid rows, empty segments 0; row 0 is the invalid
    bucket (every row there invalid, as in every caller), 0 on both
    sides."""
    rng = np.random.default_rng(2)
    r, c, segs = 4000, 6, 600
    data = rng.standard_normal((r, c)).astype(np.float32)
    ids = rng.integers(0, segs - 40, r)                     # empty segments
    valid = (rng.random(r) > 0.25) & (ids > 0)
    want = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                        segs, jnp.asarray(valid)))
    got = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids),
                            segs, torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_ATOL)
    assert (got[0] == 0).all() and (want[0] == 0).all()
    assert (got[-40:] == 0).all()


@pytest.mark.parametrize("use_bias", [False, True])
def test_gn_relu_1x1_over_masked_rows_matches_jax(use_bias):
    """The attention pool's GN-ReLU-1x1 on point rows: the GroupNorm's
    statistics and the output over the rows of ``mask`` only."""
    rng = np.random.default_rng(3)
    r, c = 3000, 16
    x = rng.standard_normal((r, c)).astype(np.float32) * 3 + 1
    mask = rng.random(r) > 0.3
    x[~mask] = 1e3                          # padding must not reach the stats
    jmod = jblocks.GnRelu1x1(c, use_bias)
    var = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), r,
                    mask=jnp.asarray(mask))
    var = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        * 0.1, var)                         # a non-trivial affine
    want = np.asarray(jmod.apply(var, jnp.asarray(x), r,
                                 mask=jnp.asarray(mask)))
    prm = jax.tree_util.tree_map(np.asarray, var["params"])
    mod = GnRelu1x1(c, c, use_bias)
    sd = {"gn.gn.weight": prm["gn"]["scale"], "gn.gn.bias": prm["gn"]["bias"],
          "conv.weight": prm["conv"]["kernel"].T}
    if use_bias:
        sd["conv.bias"] = prm["conv"]["bias"]
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    got = mod(torch.from_numpy(x), r, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=MODULE_ATOL)
    assert (got.detach().numpy()[~mask] == 0).all()


def test_deform_slice_dropout():
    """Dropout after the blend: kept features scaled by 1 / (1 - rate),
    dropped ones zero, drawn from the caller's generator (the same seed
    draws the same mask); without a mask the head is deterministic."""
    rng = np.random.default_rng(4)
    cap, c, p, rate = 300, 8, 5000, 0.2
    values = torch.from_numpy(rng.standard_normal((cap, c))
                              .astype(np.float32))
    values[0] = 0
    idx = torch.from_numpy(rng.integers(1, cap, (p, 4)))
    bary = torch.from_numpy(rng.random((p, 4)).astype(np.float32))
    mod = DeformSlice(c, 5, deform=False, dropout=rate)
    mod.linear_clasify.init_weights(torch.Generator().manual_seed(0))
    assert not hasattr(mod, "linear_deltaW")
    keep = mod.dropout_keep(p, torch.Generator().manual_seed(7))
    assert keep.shape == (p, c)
    assert abs(1.0 - float(keep.float().mean()) - rate) < 0.02
    assert torch.equal(keep, mod.dropout_keep(
        p, torch.Generator().manual_seed(7)))
    plain = mod(values, idx, bary)
    assert torch.equal(plain, mod(values, idx, bary))
    w, b = mod.linear_clasify.weight, mod.linear_clasify.bias
    sliced = torch.einsum("pvc,pv->pc", values[idx], bary)
    want = torch.where(keep, sliced / (1 - rate), torch.zeros(())) @ w.t() + b
    torch.testing.assert_close(mod(values, idx, bary, keep), want,
                               rtol=1e-6, atol=1e-6)
