"""The PyTorch port's ``lattice_ops.segment_sum`` and ``gather_rows``
against the JAX package on the CPU, with live rows in segment 0 (the
invalid bucket, which the port spreads over spare rows before it adds
them) and ids outside ``[0, num_segments)``, which both drop.

Float32 sums are held within reduction order: 1e-6 of each segment's sum
of magnitudes.  Nothing is jitted: each JAX call is one scatter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu_torch.ops import lattice_ops as lo

SUM_RTOL = 1e-6


def _ids(rng, rows: int, segs: int, zero_share: float):
    """Ids in [1, segs) with ``zero_share`` of the rows in segment 0 and
    some below 0 and at or past ``segs``."""
    ids = rng.integers(1, segs, rows)
    ids[rng.random(rows) < zero_share] = 0
    ids[rng.random(rows) < 0.02] = -1
    ids[rng.random(rows) < 0.01] = -rng.integers(2, 50)
    ids[rng.random(rows) < 0.02] = segs + rng.integers(0, 3)
    return ids


@pytest.mark.parametrize("shape,zero_share", [
    ((5000,), 0.6),        # thousands of rows in segment 0: every spare row
    ((3000, 7), 0.4),
    ((700, 3), 0.2),       # fewer rows in segment 0 than spare rows
])
def test_segment_sum_matches_jax(shape, zero_share):
    rng = np.random.default_rng(len(shape) * 10 + shape[0] % 7)
    segs = 257
    data = rng.standard_normal(shape).astype(np.float32)
    ids = _ids(rng, shape[0], segs, zero_share)
    assert (ids == 0).sum() > 100 and (ids < 0).any() and (ids >= segs).any()
    want = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                       segs))
    mags = np.asarray(jseg.segment_sum(jnp.abs(jnp.asarray(data)),
                                       jnp.asarray(ids), segs))
    got = lo.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                         segs).numpy()
    assert got.shape == want.shape == (segs,) + shape[1:]
    np.testing.assert_array_less(np.abs(got - want), SUM_RTOL * mags + 1e-30)
    # row 0 is the real sum (float64 reference), not 0
    row0 = data[ids == 0].astype(np.float64).sum(0)
    assert np.all(np.abs(got[0] - row0) <= SUM_RTOL * mags[0])
    assert np.all(np.abs(got[0]) > 0)
    again = lo.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                           segs).numpy()
    np.testing.assert_array_equal(got, again)


def test_gather_rows_backward_matches_jax():
    """``gather_rows``'s backward (a ``segment_sum`` of the cotangent rows)
    against JAX's gradient of ``values[idx]``, row 0 included."""
    rng = np.random.default_rng(5)
    rows, n, c = 300, 4000, 5
    values = rng.standard_normal((rows, c)).astype(np.float32)
    idx = rng.integers(1, rows, n)
    idx[rng.random(n) < 0.5] = 0
    cot = rng.standard_normal((n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: v[jnp.asarray(idx)], jnp.asarray(values))
    (want,) = vjp(jnp.asarray(cot))
    mags = np.asarray(jseg.segment_sum(jnp.abs(jnp.asarray(cot)),
                                       jnp.asarray(idx), rows))
    v = torch.from_numpy(values).requires_grad_(True)
    g = lo.gather_rows(v, torch.from_numpy(idx))
    np.testing.assert_array_equal(g.detach().numpy(), values[idx])
    g.backward(torch.from_numpy(cot))
    np.testing.assert_array_less(np.abs(v.grad.numpy() - np.asarray(want)),
                                 SUM_RTOL * mags + 1e-30)
    assert np.all(np.abs(v.grad.numpy()[0]) > 0)
