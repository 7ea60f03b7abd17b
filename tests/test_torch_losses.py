"""The port's losses against the JAX package's ``models/losses.py``: values
and gradients (``jax.value_and_grad``) on the same numpy inputs.

Tolerances: values to 1e-6 and gradients to 1e-5 (float32; the sums run in
another order).  Lovász ties (equal errors, here from repeated rows and the
zero errors of masked points) must order as ``lax.sort`` orders them, by
original index, or the cumulative-sum weights would differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.models import losses as jl
from temporal_latticenet_tpu_torch.models import losses as tl

VAL_TOL = 1e-6
GRAD_TOL = 1e-5


def _inputs(seed, p=600, c=26):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((p, c)).astype(np.float32) * 2
    logits[100:140] = logits[99]          # tied rows: tied errors
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = rng.integers(0, c - 4, p).astype(np.int32)   # 4 classes absent
    targets[100:140] = targets[99]
    mask = rng.random(p) < 0.8
    return logp.astype(np.float32), targets, mask


def _both(jfn, tfn, logp, targets, mask):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(logp), jnp.asarray(targets),
                                     jnp.asarray(mask))
    x = torch.tensor(logp, requires_grad=True)
    tv = tfn(x, torch.as_tensor(targets).long(), torch.as_tensor(mask))
    tv.backward()
    return (float(jv), float(tv.detach())), (np.asarray(jg),
                                             x.grad.numpy())


@pytest.mark.parametrize("name", ["nll_loss", "lovasz_softmax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grad_match_jax(name, seed):
    (jv, tv), (jg, tg) = _both(getattr(jl, name), getattr(tl, name),
                               *_inputs(seed))
    assert abs(tv - jv) <= VAL_TOL * max(1.0, abs(jv))
    np.testing.assert_allclose(tg, jg, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_segmentation_loss_matches_jax():
    logp, targets, mask = _inputs(2)

    def jfn(x, t, m):
        return jl.segmentation_loss(x, t, m)[0]

    def tfn(x, t, m):
        return tl.segmentation_loss(x, t, m)[0]
    (jv, tv), (jg, tg) = _both(jfn, tfn, logp, targets, mask)
    assert abs(tv - jv) <= VAL_TOL * max(1.0, abs(jv))
    np.testing.assert_allclose(tg, jg, rtol=GRAD_TOL, atol=GRAD_TOL)
    _, parts = tl.segmentation_loss(torch.as_tensor(logp),
                                    torch.as_tensor(targets).long(),
                                    torch.as_tensor(mask))
    assert sorted(parts) == ["lovasz", "nll"]


def test_losses_ignore_masked_and_ignored_points():
    """Changing a masked or ignore-index point changes nothing."""
    logp, targets, mask = _inputs(3)
    logp2, targets2 = logp.copy(), targets.copy()
    off = np.flatnonzero(~mask)[:5]
    ign = np.flatnonzero(mask & (targets == 0))
    assert ign.size > 0
    logp2[off] = logp2[off][:, ::-1]
    logp2[ign] = logp2[ign][:, ::-1]
    targets2[off] = 7
    for fn in (tl.nll_loss, tl.lovasz_softmax):
        a = fn(torch.as_tensor(logp), torch.as_tensor(targets).long(),
               torch.as_tensor(mask))
        b = fn(torch.as_tensor(logp2), torch.as_tensor(targets2).long(),
               torch.as_tensor(mask))
        assert float(a) == float(b)
