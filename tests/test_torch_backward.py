"""The backward halves of the port's lattice ops against ``jax.vjp`` of the
JAX package's ``custom_vjp``s, on a small real lattice in float32: the
neighborhood gather (``_Gather8Sym``), the coarsen splat (``_SplatSorted``),
the finefy slice (``_SliceSorted``, whose backward is a K2 splat) and the
straight-through packed max (``sorted_packed_max``), forward and backward.

Tolerance: 1e-5.  The gathers and the straight-through max move values
without arithmetic (equal to the bit); the splat sums runs of float32
products in another order than the JAX package's blocked scan.  The max's
winner mask (which rows receive a gradient) is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu.ops import lattice_ops as jlo
from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu_torch.ops import lattice_ops as lo
from temporal_latticenet_tpu_torch.ops import seq_lattice as sl
from temporal_latticenet_tpu_torch.ops.segment import sorted_packed_max

TOL = 1e-5
CAPS = (4096, 2048, 1024)


@pytest.fixture(scope="module")
def lattice():
    pos, _, _, mask = lidar_sequence(np.random.default_rng(1), frames=2,
                                     max_points=512, n_az=8)
    return sl.build_sequence_lattice(torch.as_tensor(pos),
                                     torch.as_tensor(mask), 0.5, CAPS, 2)


def _jlink(link):
    j = lambda t: jnp.asarray(t.numpy().astype(  # noqa: E731
        np.int32 if t.dtype == torch.int64 else t.numpy().dtype))
    return jlo.LevelLink(
        corner_idx=j(link.corner_idx), corner_bary=j(link.corner_bary),
        sorted_src=j(link.sorted_src), sorted_w=j(link.sorted_w),
        sorted_dst=j(link.sorted_dst), tailpos=j(link.tailpos),
        tail_live=j(link.tail_live))


def _vjp_both(jfn, tfn, x, ct):
    """(forward, input cotangent) of the JAX and the port function."""
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    ty = tfn(xt)
    ty.backward(torch.as_tensor(ct))
    return (np.asarray(jy), ty.detach().numpy()), (np.asarray(jg),
                                                   xt.grad.numpy())


def test_gather8_sym_backward_matches_jax(lattice):
    rng = np.random.default_rng(0)
    lvl = lattice.levels[0]
    cap = lvl.nbr_idx.shape[0]
    count = int(lvl.counts[-1])
    idx8 = lvl.nbr_idx[:, :8]
    x = rng.standard_normal((cap, 32)).astype(np.float32)
    x[0] = 0
    x[count:] = 0
    ct = rng.standard_normal((cap, 8, 32)).astype(np.float32)
    ct[0] = 0                           # the mask_rows invariant upstream
    ct[count:] = 0
    (jy, ty), (jg, tg) = _vjp_both(
        lambda v: jlo._gather8_sym(v, jnp.asarray(idx8.numpy(), jnp.int32)),
        lambda v: lo.gather8_sym(v, idx8), x, ct)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)
    # with the invariant it is the exact transpose of the gather
    dense = np.zeros_like(x)
    np.add.at(dense, idx8.numpy().reshape(-1), ct.reshape(-1, 32))
    dense[0] = 0
    np.testing.assert_allclose(tg[1:], dense[1:], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("level", [0, 1])
def test_splat_sorted_backward_matches_jax(lattice, level):
    rng = np.random.default_rng(level)
    link = lattice.links[level]
    cf, cc = link.corner_idx.shape[0], link.tailpos.shape[0]
    c = 32
    x = rng.standard_normal((cf, c)).astype(np.float32)
    ct = rng.standard_normal((cc, c)).astype(np.float32)
    jl = _jlink(link)
    (jy, ty), (jg, tg) = _vjp_both(
        lambda v: jlo.splat_to_coarse(v, jl, cc),
        lambda v: lo.splat_to_coarse(v, link), x, ct)
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("level", [0, 1])
def test_slice_sorted_backward_matches_jax(lattice, level):
    rng = np.random.default_rng(10 + level)
    link = lattice.links[level]
    cf, cc = link.corner_idx.shape[0], link.tailpos.shape[0]
    c = 64
    x = rng.standard_normal((cc, c)).astype(np.float32)
    ct = rng.standard_normal((cf, c)).astype(np.float32)
    jl = _jlink(link)
    (jy, ty), (jg, tg) = _vjp_both(
        lambda v: jlo.slice_to_fine(v, jl),
        lambda v: lo.slice_to_fine(v, link), x, ct)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("packed", ["0", "1"])
def test_sorted_packed_max_backward_matches_jax(monkeypatch, packed):
    """Forward (max and winner bary) and the straight-through backward, on
    the default route and on the two-level packed route."""
    monkeypatch.setenv("TLN_MAXSCAN_PACKED", packed)
    rng = np.random.default_rng(3)
    t, cap, c = 2, 300, 16
    nb = t * cap
    # rows sorted by bucket; some buckets empty, some rows dead (bucket nb)
    sizes = rng.choice([0, 1, 2, 5, 17, 40], size=nb)
    bucket = np.repeat(np.arange(nb), sizes)
    dead = rng.integers(0, 30)
    bucket = np.concatenate([bucket, np.full(dead, nb)])
    q = bucket.shape[0]
    live = bucket < nb
    head = np.ones(q, bool)
    head[1:] = bucket[1:] != bucket[:-1]
    hc = np.cumsum(head).astype(np.int32) - 1
    ends = np.flatnonzero(np.append(bucket[1:] != bucket[:-1], True))
    tailpos = np.zeros(nb, np.int64)
    bucket_live = np.zeros(nb, bool)
    for e in ends:
        if bucket[e] < nb:
            tailpos[bucket[e]] = e
            bucket_live[bucket[e]] = True
    # values on a coarse grid so that some runs tie in bf16
    data = (rng.integers(-40, 40, (q, c)) / 8).astype(np.float32)
    bary = rng.random(q).astype(np.float32)
    ct_mx = rng.standard_normal((nb, c)).astype(np.float32)
    ct_b = rng.standard_normal((nb, c)).astype(np.float32)

    def jfn(d, b):
        return jseg.sorted_packed_max(
            d, b, jnp.asarray(live), jnp.asarray(head),
            jnp.asarray(np.minimum(bucket, nb).astype(np.int32)),
            jnp.asarray(tailpos.reshape(t, cap).astype(np.int32)),
            jnp.asarray(bucket_live.reshape(t, cap)))
    (jmx, jbs), vjp = jax.vjp(jfn, jnp.asarray(data), jnp.asarray(bary))
    jdd, jdb = vjp((jnp.asarray(ct_mx), jnp.asarray(ct_b)))

    d = torch.tensor(data, requires_grad=True)
    b = torch.tensor(bary, requires_grad=True)
    mx, bs = sorted_packed_max(
        d, b, torch.as_tensor(live), torch.as_tensor(hc),
        torch.as_tensor(bucket), torch.as_tensor(tailpos.reshape(t, cap)),
        torch.as_tensor(bucket_live.reshape(t, cap)))
    torch.autograd.backward([mx, bs], [torch.as_tensor(ct_mx),
                                       torch.as_tensor(ct_b)])
    np.testing.assert_array_equal(mx.detach().numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(bs.detach().numpy(), np.asarray(jbs))
    np.testing.assert_array_equal(d.grad.numpy() != 0, np.asarray(jdd) != 0)
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(jdd))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb), rtol=TOL,
                               atol=TOL)
    assert (d.grad.numpy() != 0).any()
