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

from .test_torch_configs import _one_torch_thread  # noqa: F401

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


def _jax_vjp(jfn, primals, cts):
    """JAX's forward of ``jfn`` at ``primals`` and the primals' cotangents
    for ``cts``, as one jitted graph: run op by op, each of their operations
    compiled alone, which took most of this file's time on the CPU.  (The
    packed max below stays op by op: its bit-equal winner bary is eager
    JAX's, and XLA's fusion moves a last bit of it.)"""
    def f(p, c):
        y, vjp = jax.vjp(jfn, *p)
        return y, vjp(c)
    return jax.jit(f)(primals, cts)


def _vjp_both(jfn, tfn, x, ct):
    """(forward, input cotangent) of the JAX and the port function."""
    jy, (jg,) = _jax_vjp(jfn, (jnp.asarray(x),), jnp.asarray(ct))
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


def test_lattice_conv_bf16_function_matches_jax(lattice):
    """The bf16 lattice convolution's autograd Function (``lattice_ops.
    _LatticeConvBf16``: kernel K6's forward, or its plain version here on
    the CPU) against ``jax.vjp`` of the JAX package's ``LatticeConv`` with
    ``dtype="bfloat16"``, for the values, the weight and the bias, on the
    same inputs and a level-0 table of a real lattice.

    Both sum the same bf16-exact products in float32, in other orders: the
    output and the bias's gradient lie within 2 (n + 1) 2^-24 of the sum of
    the terms' magnitudes (n terms).  The weight's and the values'
    gradients are rounded to bf16 on the way (the weight's once; the
    values' three times: the rows' cotangent, the taps' adjoint and its sum
    with the center tap), where the float32 sums' other order may move a
    rounding by one bf16 step, 2^-7 of the magnitude at most: they lie
    within 2^-7 per rounding of the terms' magnitudes, plus 2^-7 of the
    value."""
    from temporal_latticenet_tpu.models.blocks import LatticeConv

    rng = np.random.default_rng(5)
    lvl = lattice.levels[0]
    cap = lvl.nbr_idx.shape[0]
    count = int(lvl.counts[-1])
    cin, cout = 24, 40
    x = rng.standard_normal((cap, cin)).astype(np.float32)
    x[0] = 0
    x[count:] = 0
    w = (rng.standard_normal((9 * cin, cout)) / np.sqrt(9 * cin)
         ).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ct = rng.standard_normal((cap, cout)).astype(np.float32)
    jnbr = jlo.NeighborTable(idx=jnp.asarray(lvl.nbr_idx.numpy(), jnp.int32),
                             found=jnp.asarray(lvl.nbr_found.numpy()))
    conv = LatticeConv(cout, use_bias=True, dtype="bfloat16")

    def jfn(v, k, bb):
        return conv.apply({"params": {"kernel": k, "bias": bb}}, v, jnbr,
                          count)
    jy, jg = _jax_vjp(jfn, tuple(map(jnp.asarray, (x, w, b))),
                      jnp.asarray(ct))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    nbr = lo.NeighborTable(lvl.nbr_idx, lvl.nbr_found)
    ty = lo._LatticeConvBf16.apply(*leaves, nbr, lvl.counts[-1])
    ty.backward(torch.as_tensor(ct))
    u, step = 2.0 ** -24, 2.0 ** -7

    # the magnitudes of each result's terms
    live = (np.arange(cap) > 0) & (np.arange(cap) < count)
    rows = lo.gather_rowified(torch.tensor(x).to(torch.bfloat16),
                              nbr).double().numpy()
    wb = torch.tensor(w).to(torch.bfloat16).double().numpy()
    dy = np.where(live[:, None], ct, 0).astype(np.float64)
    mag_y = np.abs(rows) @ np.abs(wb) + np.abs(b)
    mag_b = np.abs(dy).sum(0)
    mag_w = np.abs(rows).T @ np.abs(dy)
    mag_rows = (np.abs(dy) @ np.abs(wb).T).reshape(cap, 9, cin)
    mag_v = mag_rows[:, 8].copy()
    np.add.at(mag_v, lvl.nbr_idx[:, :8].numpy().reshape(-1),
              mag_rows[:, :8].reshape(-1, cin))
    mag_v[0] = 0

    def within(got, want, tol):
        err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
        assert (err <= tol).all(), float((err / np.maximum(tol, 1e-30)).max())

    within(ty.detach().numpy(), jy, 2 * (9 * cin + 2) * u * mag_y)
    gv, gw, gb = (t.grad.numpy() for t in leaves)
    within(gb, jg[2], 2 * (cap + 1) * u * mag_b)
    within(gw, jg[1], step * mag_w + step * np.abs(np.asarray(jg[1])))
    within(gv, jg[0], 3 * step * mag_v + step * np.abs(np.asarray(jg[0])))
    # rows 0 and from the count up receive nothing, on both sides
    assert not gv[~live].any() and not np.asarray(jg[0])[~live].any()
