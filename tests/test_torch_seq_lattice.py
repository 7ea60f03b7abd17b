"""Whole-sequence lattice build of the PyTorch port against the JAX package
(CPU paths of both, the port's through the plain versions of K1-K3).

Every integer field (keys, births, counts, neighbor tables, row indices,
links, tail positions, packed values) must be equal.  Floats:

* relative positions are means of float32 sums and may differ only in
  summation order (atol 1e-5 m on clouds of tens of metres);
* barycentric weights: jitted XLA contracts the simplex arithmetic into
  fused multiply-adds, so the JAX package's jitted weights differ from its
  own eager (unfused) ones by a few float32 ulps of the elevated
  coordinates (measured up to 1.5e-5 on clouds of tens of metres).  The
  port reproduces the unfused arithmetic bit for bit
  (test_torch_permutohedral.py, test_torch_kernels.py); here the weights
  are held to atol 3e-5, and their 1/65535 quantisation to one step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu.ops import seq_lattice as jsl
from temporal_latticenet_tpu_torch.ops import permutohedral as tpm
from temporal_latticenet_tpu_torch.ops import seq_lattice as tsl
from temporal_latticenet_tpu_torch.ops.fused_simplex import fused_simplex_pack

# sigma 0.5: a power-of-two divisor, so jitted XLA (which may turn the
# division into a multiplication by the reciprocal) and the port scale the
# points bit-identically; at 0.6 the weights would differ in the last bits
SIGMA = 0.5
CAPS = (8192, 6144, 4096)
NBR_CAPS = (7168, 5376, 3584)
TOL = {"row_rel_pos": 1e-5, "rel": 1e-5, "row_bary": 3e-5,
       "point_bary": 3e-5, "corner_bary": 3e-5, "sorted_w": 3e-5,
       "bary": 1.01 / 65535}


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _tn(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _assert_same(name, j, t):
    a, b = _np(j), _tn(t)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    tol = TOL.get(name.split(".")[-1])
    if tol is not None:
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)


def _compare_lattice(jl, tl):
    assert len(jl.levels) == len(tl.levels)
    for i, (a, b) in enumerate(zip(jl.levels, tl.levels)):
        for f in dataclasses.fields(b):
            _assert_same(f"levels{i}.{f.name}", getattr(a, f.name),
                         getattr(b, f.name))
    for i, (a, b) in enumerate(zip(jl.links, tl.links)):
        for f in dataclasses.fields(b):
            _assert_same(f"links{i}.{f.name}", getattr(a, f.name),
                         getattr(b, f.name))
    for f in ("row_vertex", "row_bary", "row_valid", "row_rel_pos",
              "point_vertex", "point_bary", "nr_points"):
        a, b = getattr(jl, f), getattr(tl, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _assert_same(f, a, b)
    assert (jl.sorted_pn is None) == (tl.sorted_pn is None)
    if tl.sorted_pn is not None:
        for f in dataclasses.fields(tl.sorted_pn):
            a, b = getattr(jl.sorted_pn, f.name), getattr(tl.sorted_pn, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                _assert_same("sorted_pn." + f.name, a, b)


def _frames(t, p=1024, seed=0):
    rng = np.random.default_rng(seed)
    return lidar_sequence(rng, frames=t, max_points=p, n_az=p // 64)


@pytest.mark.parametrize("t,with_pn,caps,nbr_caps", [
    (4, True, CAPS, NBR_CAPS),
    (4, False, CAPS, None),
    (3, True, CAPS, NBR_CAPS),
    (1, True, CAPS, None),
    # saturated: the union drops youngest-then-largest at every level
    (4, True, (2048, 1024, 512), None),
])
def test_sequence_lattice_fields_equal(t, with_pn, caps, nbr_caps):
    pos, val, _, mask = _frames(t)
    build = jax.jit(functools.partial(
        jsl.build_sequence_lattice, sigma=SIGMA, capacities=caps,
        nr_downsamples=2, nbr_caps=nbr_caps, want_row_rel=not with_pn))
    jl = build(jnp.asarray(pos), jnp.asarray(mask),
               pn_values=jnp.asarray(val) if with_pn else None)
    tl = tsl.build_sequence_lattice(
        torch.from_numpy(pos), torch.from_numpy(mask), SIGMA, caps, 2,
        nbr_caps=nbr_caps,
        pn_values=torch.from_numpy(val) if with_pn else None,
        want_row_rel=not with_pn)
    if caps[0] == 2048:
        assert int(tl.levels[0].counts[-1]) == caps[0]       # really full
    _compare_lattice(jl, tl)


@pytest.mark.parametrize("first_is_head", [True, False])
def test_scan_helpers_equal(first_is_head):
    """The union's scan helpers (K2 ``sum`` and ``first`` underneath)."""
    rng = np.random.default_rng(5)
    q = 3000
    head = rng.random(q) < 0.05
    head[0] = first_is_head
    ival = rng.integers(-50, 50, q).astype(np.int32)
    fval = rng.standard_normal((q, 4)).astype(np.float32)
    jh, th = jnp.asarray(head), torch.from_numpy(head)
    np.testing.assert_array_equal(
        tsl._blocked_cumsum(torch.from_numpy(ival)).numpy(),
        np.asarray(jsl._blocked_cumsum(jnp.asarray(ival))))
    np.testing.assert_array_equal(
        tsl._seg_copy_head(th, torch.from_numpy(ival)).numpy(),
        np.asarray(jsl._seg_copy_head(jh, jnp.asarray(ival))))
    np.testing.assert_allclose(
        tsl._seg_sum_rows(th, torch.from_numpy(fval)).numpy(),
        np.asarray(jsl._seg_sum_rows(jh, jnp.asarray(fval))),
        rtol=1e-5, atol=1e-5)


def test_no_mean_union_and_trim_equal():
    """The no-local-mean union (birth from the candidate order), unsaturated
    and saturated, and the trimmed views the engine hands to the non-final
    and final frames."""
    pos, _, _, mask = _frames(4, seed=1)
    t = mask.shape[0]
    y = tpm.scale_positions(torch.from_numpy(pos).reshape(-1, 3), SIGMA)
    packed4, _ = fused_simplex_pack(y, torch.from_numpy(mask).reshape(-1))
    cand = packed4.reshape(-1)
    n = cand.shape[0]
    for cap in (CAPS[0], 2048):
        union = jax.jit(functools.partial(jsl._union_with_birth,
                                          capacity=cap, n_frames=t))
        want = union(jnp.asarray(cand.numpy().astype(np.uint32)),
                     jnp.arange(n, dtype=jnp.int32))
        got = tsl._union_with_birth(cand, torch.arange(n), cap, t)
        for name, a, b in zip(("packed", "birth", "row_idx", "counts"),
                              want, got):
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(a).astype(np.int64), err_msg=name)

    build = jax.jit(functools.partial(
        jsl.build_sequence_lattice, sigma=SIGMA, capacities=CAPS,
        nr_downsamples=2))
    jl = build(jnp.asarray(pos), jnp.asarray(mask))
    tl = tsl.build_sequence_lattice(torch.from_numpy(pos),
                                    torch.from_numpy(mask), SIGMA, CAPS, 2)
    for trim in ((6144, 4608, 3072), NBR_CAPS):
        _compare_lattice(jsl.trim_sequence_lattice(jl, trim),
                         tsl.trim_sequence_lattice(tl, trim))
