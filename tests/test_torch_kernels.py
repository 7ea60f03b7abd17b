"""Kernels K1-K5 of the PyTorch port against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as tests/test_pallas_*.py do),
plus the CUDA kernels against their plain versions on the card.

Tolerances: integer outputs (keys, run ids, ``first``, ``max``, packed
maxima) are bit-equal; float32 sums may differ only in summation order
(the plain version sums in float64 and rounds once), so they are held to
1e-4 relative to the magnitude of the running sums.  K5's windowed rows
have a coverage contract, not one value: each row lies between the exact
max over its last ``2 * window - 1`` same-run rows and the full-run max.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from temporal_latticenet_tpu.ops import pallas_scan as ps
from temporal_latticenet_tpu.ops import permutohedral as jpm
from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu.ops.pallas_simplex import fused_simplex_pack as j_fused
from temporal_latticenet_tpu_torch.ops import _cuda
from temporal_latticenet_tpu_torch.ops import fused_simplex as fs
from temporal_latticenet_tpu_torch.ops import seg_scan as ss
from temporal_latticenet_tpu_torch.ops import segment as tseg
from temporal_latticenet_tpu_torch.ops import seq_lattice as tsl

from .test_torch_configs import _one_torch_thread  # noqa: F401


def _runs(rng, q, p=0.05):
    heads = rng.random(q) < p
    heads[0] = True
    return np.cumsum(heads).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K1 fused_simplex_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.6, 1.7])
def test_k1_plain_matches_pallas_bit_exact(sigma):
    rng = np.random.default_rng(0)
    n = 1500
    pos = (rng.standard_normal((n, 3)) * 25).astype(np.float32)
    pos[:10] = rng.integers(-8, 8, (10, 3))          # lattice-point ties
    pos[10] = [1e5, 1e5, 1e5]                        # out of packed range
    mask = rng.random(n) < 0.9
    jp, jb = j_fused(jnp.asarray(pos), jnp.asarray(mask), sigma, rows=8,
                     interpret=True)
    # same pre-scaled y on both sides (the sigma division stays outside)
    y = np.asarray(jpm.scale_positions(jnp.asarray(pos), sigma))
    tp, tb = fs.fused_simplex_pack(_t(y), _t(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_k1_rejects_bad_input():
    with pytest.raises(ValueError):
        fs.fused_simplex_pack(torch.zeros(4, 2), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        fs.fused_simplex_pack(torch.zeros(4, 3), torch.ones(4))


# ---------------------------------------------------------------------------
# K2 sorted_segment_scan: every mode, dtype and C of the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [("sum", np.float32), ("sum", np.int32),
                                        ("max", np.int32),
                                        ("first", np.float32),
                                        ("first", np.int32)])
@pytest.mark.parametrize("c", [1, 4, 64, 128])
def test_k2_plain_matches_pallas(mode, dtype, c):
    rng = np.random.default_rng(c)
    q = 2048 if c <= 4 else 512
    hc = _runs(rng, q)
    if dtype == np.float32:
        x = rng.standard_normal((q, c)).astype(dtype)
    else:
        x = rng.integers(-1000, 1000, (q, c)).astype(dtype)
    want = np.asarray(ps.sorted_segment_scan(jnp.asarray(hc), jnp.asarray(x),
                                             mode, rows=8, interpret=True))
    got = ss.sorted_segment_scan(_t(hc), _t(x), mode).numpy()
    assert got.dtype == x.dtype
    if mode == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def test_k2_single_run_cumsum_is_exact():
    """All-zero run ids: the union's int32 cumsum, one run over all rows."""
    rng = np.random.default_rng(3)
    q = 5000
    x = rng.integers(0, 3, (q, 1)).astype(np.int32)
    got = ss.sorted_segment_scan(torch.zeros(q, dtype=torch.int32), _t(x),
                                 "sum")
    np.testing.assert_array_equal(got.numpy()[:, 0], np.cumsum(x[:, 0]))


def test_k2_one_run_form_is_cumsum():
    """``head_count=None`` (one run, no ids) equals torch.cumsum, the
    zero-ids form and the JAX package's ``_blocked_cumsum``."""
    # imported here (it needs flax), so that the card test below also runs
    # where only jax is installed
    from temporal_latticenet_tpu.ops import seq_lattice as jsl
    rng = np.random.default_rng(4)
    x = rng.integers(-5, 100, 5001).astype(np.int32)
    got = ss.sorted_segment_scan(None, _t(x[:, None]), "sum")[:, 0]
    zero_ids = ss.sorted_segment_scan(torch.zeros(5001, dtype=torch.int32),
                                      _t(x[:, None]), "sum")[:, 0]
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cumsum(_t(x), 0, dtype=torch.int32))
    assert torch.equal(got, zero_ids)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsl._blocked_cumsum(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tsl._blocked_cumsum(_t(x)).numpy(), got.numpy())


@pytest.mark.parametrize("q,c,vec,want", [
    (2_097_152, 1, False, (1, 1, 1, 4096, 512)),      # one-run cumsum, first
    (2_097_152, 4, True, (4, 1, 1, 4096, 512)),       # K3's float4 rows
    (163_840, 64, True, (4, 16, 1, 256, 640)),        # coarsen splat
    (2_097_152, 64, True, (4, 16, 1, 256, 8192)),     # K4's pointnet max
    (81_920, 128, True, (4, 32, 1, 128, 640)),
    (163_840, 128, True, (4, 32, 1, 128, 1280)),      # slice backward
    (100, 3, False, (1, 4, 1, 1024, 1)),              # below one tile
    (5000, 2048, True, (4, 256, 2, 16, 313)),         # channel blocks
])
def test_lookback_plan(q, c, vec, want):
    """The wrapper's tile plan: every row and channel covered once, at least
    128 rows per tile at the main path's C % 4 == 0 shapes, and a tile state
    that holds the counters and a 64-bit word per tile (C = 1) or an int32
    status per (channel block, tile)."""
    plan = ss._lookback_plan(q, c, vec)
    assert tuple(plan) == want
    assert plan.ntiles * plan.rows >= q > (plan.ntiles - 1) * plan.rows
    assert plan.ncb * plan.w * plan.vw >= c
    assert plan.rows * plan.w == ss._LB_THREADS * ss._LB_STRIP
    header = 8 * ((plan.ncb + 1) // 2)
    tiles = 8 * plan.ntiles if c == 1 else 4 * plan.ncb * plan.ntiles
    assert 8 * plan.state_words >= header + tiles


def test_k2_rejects_bad_input():
    hc = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        ss.sorted_segment_scan(hc, torch.zeros(8, 2), "max")      # f32 max
    with pytest.raises(ValueError):
        ss.sorted_segment_scan(hc.long(), torch.zeros(8, 2), "sum")
    with pytest.raises(ValueError):
        ss.sorted_segment_scan(hc, torch.zeros(8, 2), "mean")
    with pytest.raises(ValueError):                               # one run:
        ss.sorted_segment_scan(None, torch.zeros(8, 2, dtype=torch.int32),
                               "max")                             # sum only


# ---------------------------------------------------------------------------
# K3 seg_sum_tails
# ---------------------------------------------------------------------------

def test_k3_plain_matches_pallas_tails():
    rng = np.random.default_rng(9)
    q, c = 4096, 4
    lens = []
    while sum(lens) < q - 400:
        lens.append(int(rng.choice([1, 2, 5, 31, 32, 33, 64, 200])))
    lens.append(q - sum(lens))
    heads = np.zeros(q, bool)
    heads[np.cumsum([0] + lens[:-1])] = True
    ids = np.cumsum(heads).astype(np.int32)
    tails = np.concatenate([np.flatnonzero(heads)[1:] - 1, [q - 1]])
    x = rng.standard_normal((q, c)).astype(np.float32)
    want = np.asarray(ps.seg_sum_tails(jnp.asarray(ids), jnp.asarray(x),
                                       jnp.asarray(tails), interpret=True))
    got = ss.seg_sum_tails(_t(ids), _t(x), _t(tails.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # integer-valued float32: exact regardless of summation order
    xi = rng.integers(0, 100, (q, c)).astype(np.float32)
    got = ss.seg_sum_tails(_t(ids), _t(xi), _t(tails.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.stack([xi[ids == ids[t]].sum(0) for t in tails]))


# ---------------------------------------------------------------------------
# K4 sorted_segment_max_u32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [8, 64])
def test_k4_plain_matches_pallas_full_window(c):
    rng = np.random.default_rng(c)
    q = 2048
    hc = _runs(rng, q, 0.1)
    x = rng.integers(0, 2**32, (q, c), dtype=np.uint32)
    want = np.asarray(ps.sorted_segment_max_u32(jnp.asarray(hc),
                                                jnp.asarray(x), tile=512,
                                                interpret=True))
    got = ss.sorted_segment_max_u32(_t(hc), _t(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("case,q,c", [
    ("one run", 2048, 64),            # every tile continues the run
    ("below one tile", 100, 64),
    ("ragged last tile", 256 * 7 + 3, 64),
    ("4-byte vectors", 1000, 3),
    ("summary scan", 2048, 64),       # every 16th row of a longer input
])
def test_k4_plain_matches_pallas_lookback_cases(case, q, c):
    """K4's function at the look-back's edge cases, bit-equal to the Pallas
    kernel (the CUDA kernel is held to the same plain version on the
    card)."""
    rng = np.random.default_rng(q + c)
    hc = np.zeros(q, np.int32) if case == "one run" else _runs(rng, q, 0.1)
    x = rng.integers(0, 2**32, (q, c), dtype=np.uint32)
    if case == "summary scan":
        hc = _runs(rng, 16 * q, 0.05)[15::16]
    want = np.asarray(ps.sorted_segment_max_u32(jnp.asarray(hc),
                                                jnp.asarray(x), tile=512,
                                                interpret=True))
    got = ss.sorted_segment_max_u32(_t(hc), _t(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_k4_tails_match_pallas_two_level():
    """The port's full-window tails equal the JAX package's windowed
    two-level tail max bit for bit (runs from 1 row to over a tile)."""
    rng = np.random.default_rng(7)
    q, chunk = 8192, 16
    lens = []
    while sum(lens) < q - 3000:
        lens.append(int(rng.choice([1, 2, 3, 7, 15, 16, 17, 32, 100])))
    lens += [2500, 16, 1]
    lens.append(q - sum(lens))
    heads = np.zeros(q, bool)
    heads[np.cumsum([0] + lens[:-1])] = True
    tails = np.concatenate([np.flatnonzero(heads)[1:] - 1, [q - 1]])
    x = rng.integers(0, 2**32, (q, 8), dtype=np.uint32)
    want = np.asarray(jseg._seg_max_tails_twolevel(
        jnp.asarray(heads), jnp.asarray(x), jnp.asarray(tails), chunk=chunk,
        interpret=True))
    hc = np.cumsum(heads).astype(np.int32)
    got = ss.sorted_segment_max_u32(_t(hc), _t(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy()[tails].view(np.uint32), want)


# ---------------------------------------------------------------------------
# K5 sorted_segment_max_window (the TPU's lane-packed windowed kernel, taken
# under TLN_MAXSCAN_PACKED=1)
# ---------------------------------------------------------------------------

def _adversarial_heads(rng, q, chunk=16):
    """Run lengths from 1 to over a kernel tile, with heads and tails on
    chunk and tile boundaries (tests/test_pallas_scan.py)."""
    lens = []
    while sum(lens) < q - 3000:
        lens.append(int(rng.choice([1, 2, 3, 7, chunk - 1, chunk, chunk + 1,
                                    2 * chunk, 100])))
    lens += [2500, 16, 1]
    lens.append(q - sum(lens))
    heads = np.zeros(q, bool)
    heads[np.cumsum([0] + lens[:-1])] = True
    return heads


def _window_max(hc, x, rows):
    """numpy: per row, the uint32 max over its last ``rows`` same-run rows."""
    out = x.copy()
    for j in range(1, rows):
        same = (hc[j:] == hc[:-j])[:, None]
        out[j:] = np.where(same, np.maximum(out[j:], x[:-j]), out[j:])
    return out


@pytest.mark.parametrize("c", [16, 64])
def test_k5_rows_meet_the_coverage_contract(monkeypatch, c):
    """The Pallas packed kernel's rows (interpret mode) and the port's plain
    rows both lie between the exact max over the last 2W-1 same-run rows
    and the full-run max; the plain rows are exactly the 2W-row max."""
    monkeypatch.setenv("TLN_MAXSCAN_PACKED", "1")
    rng = np.random.default_rng(c)
    q, window = 4096, 8
    hc = np.cumsum(_adversarial_heads(rng, q)).astype(np.int32)
    x = rng.integers(0, 2**32, (q, c), dtype=np.uint32)
    pallas = np.asarray(ps.sorted_segment_max_u32(
        jnp.asarray(hc), jnp.asarray(x), tile=512, interpret=True,
        max_window=window))
    plain = ss.sorted_segment_max_window(
        _t(hc), _t(x.view(np.int32)), window).numpy().view(np.uint32)
    lo = _window_max(hc, x, 2 * window - 1)
    hi = _window_max(hc, x, q)
    for rows in (pallas, plain):
        assert (rows >= lo).all() and (rows <= hi).all()
    np.testing.assert_array_equal(plain, _window_max(hc, x, 2 * window))


def test_k5_full_window_is_k4(monkeypatch):
    """At window=None the packed Pallas kernel computes K4's function: the
    port routes it to K4 (plain version on the CPU)."""
    monkeypatch.setenv("TLN_MAXSCAN_PACKED", "1")
    rng = np.random.default_rng(5)
    q, c = 2048, 64
    hc = _runs(rng, q, 0.1)
    x = rng.integers(0, 2**32, (q, c), dtype=np.uint32)
    want = np.asarray(ps.sorted_segment_max_u32(
        jnp.asarray(hc), jnp.asarray(x), tile=512, interpret=True))
    xi = _t(x.view(np.int32))
    np.testing.assert_array_equal(
        ss.sorted_segment_max_u32_plain(_t(hc), xi).numpy().view(np.uint32),
        want)
    np.testing.assert_array_equal(
        ss.sorted_segment_max_window(_t(hc), xi, None).numpy()
        .view(np.uint32), want)


@pytest.mark.parametrize("case", ["adversarial", "unpadded"])
@pytest.mark.parametrize("c", [16, 64])
def test_twolevel_tails_match_pallas_packed(monkeypatch, c, case):
    """The port's two-level tail max (K5 window + K4 summary scan +
    correction) equals the JAX package's on its packed route, bit for bit,
    and equals the true per-run max."""
    monkeypatch.setenv("TLN_MAXSCAN_PACKED", "1")
    rng = np.random.default_rng(c)
    if case == "adversarial":
        heads = _adversarial_heads(rng, 8192)
    else:                                    # Q not a multiple of the chunk
        heads = rng.random(3001) < 0.08
        heads[0] = True
    q = heads.shape[0]
    tails = np.concatenate([np.flatnonzero(heads)[1:] - 1, [q - 1]])
    x = rng.integers(0, 2**32, (q, c), dtype=np.uint32)
    want = np.asarray(jseg._seg_max_tails_twolevel(
        jnp.asarray(heads), jnp.asarray(x), jnp.asarray(tails), chunk=16,
        interpret=True))
    hc = np.cumsum(heads).astype(np.int32)
    got = tseg._seg_max_tails_twolevel(_t(hc), _t(x.view(np.int32)),
                                       _t(tails.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, _window_max(hc, x, q)[tails])


def test_k5_rejects_bad_window():
    hc = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, 4, dtype=torch.int32)
    for w in (0, ss.MAX_WINDOW + 1):
        with pytest.raises(ValueError):
            ss.sorted_segment_max_window(hc, x, w)
    with pytest.raises(ValueError):
        ss.sorted_segment_max_window(hc, x.float(), 8)
    with pytest.raises(ValueError):
        ss.sorted_segment_max_window(hc, torch.zeros(8, 65, dtype=torch.int32),
                                     8)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

def _within_sum_bound(ids, x, got, want):
    """Float32 summation in any order: |err| <= (n + 1) 2^-24 sum|x| per
    run of n rows (the plain version sums in float64 and rounds once)."""
    if ids is None:
        n = torch.full((x.shape[0],), x.shape[0], device=x.device)
    else:
        _, inv, cnt = torch.unique_consecutive(ids, return_inverse=True,
                                               return_counts=True)
        n = cnt[inv]
    absum = ss.sorted_segment_scan_plain(ids, x.abs(), "sum").double()
    tol = (n.double()[:, None] + 1) * 2.0 ** -24 * absum
    return bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    g = torch.Generator().manual_seed(0)
    dev = cuda_device
    y = (torch.randn(70001, 3, generator=g) * 40).to(dev)
    m = (torch.rand(70001, generator=g) < 0.9).to(dev)
    before = _cuda.launch_counts()
    pk, b = fs.fused_simplex_pack(y, m)
    pk2, b2 = fs.fused_simplex_pack_plain(y, m)
    assert torch.equal(pk, pk2) and torch.equal(b, b2)
    q = 300007
    hc = torch.cumsum((torch.rand(q, generator=g) < 0.1).int(), 0).int().to(dev)
    one = torch.zeros(q, dtype=torch.int32, device=dev)
    n_scans = 0
    # (run ids, rows, C, mode, dtype): short runs, one run with and without
    # ids (the longest look-back), below one tile, a ragged last tile, and a
    # C that takes neither the row-vector nor the channel-vector loads
    for ids, rows, c, mode, dt in [
            (hc, q, 1, "sum", torch.int32), (hc, q, 1, "first", torch.int32),
            (hc, q, 64, "sum", torch.float32),
            (hc, q, 128, "sum", torch.float32),
            (hc, q, 4, "max", torch.int32), (hc, q, 4, "first", torch.float32),
            (None, q, 1, "sum", torch.int32), (one, q, 1, "sum", torch.int32),
            (one, q, 128, "sum", torch.float32),
            (None, q, 4, "sum", torch.int32),
            (hc, 100, 1, "sum", torch.int32),
            (hc, 100, 64, "sum", torch.float32),
            (hc, 4096 + 17, 1, "first", torch.int32),
            (hc, 128 * 7 + 3, 128, "sum", torch.float32),
            (hc, 5003, 3, "sum", torch.float32)]:
        ids = None if ids is None else ids[:rows].contiguous()
        x = (torch.randn(rows, c, generator=g) if dt == torch.float32 else
             torch.randint(-999, 999, (rows, c), generator=g, dtype=dt)
             ).to(dev)
        got = ss.sorted_segment_scan(ids, x, mode)
        want = ss.sorted_segment_scan_plain(ids, x, mode)
        n_scans += 1
        if dt == torch.float32 and mode == "sum":
            assert _within_sum_bound(ids, x, got, want)
            # bit-equal from call to call
            assert torch.equal(got, ss.sorted_segment_scan(ids, x, mode))
            n_scans += 1
        else:
            assert torch.equal(got, want)
    x = torch.randn(q, 4, generator=g).to(dev)
    # in any order, repeated, mid-run and out of range
    tails = torch.cat([torch.randint(0, q, (5000,), generator=g),
                       torch.tensor([5, 5, 5, q - 1, q - 1, -1, q, 10 * q])
                       ]).to(dev)
    got = ss.seg_sum_tails(hc, x, tails)
    torch.testing.assert_close(got, ss.seg_sum_tails_plain(hc, x, tails),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, ss.seg_sum_tails(hc, x, tails))
    xi = torch.randint(-2**31, 2**31 - 1, (q, 64), generator=g,
                       dtype=torch.int64).to(torch.int32).to(dev)
    # K4 on the same look-back: short runs, one run over every row (the
    # longest look-back), below one tile, a ragged last tile, C that take
    # 4-byte vectors (C = 1: a thread per row), and the two-level route's
    # summary scan (every 16th row)
    n_max = 0
    for ids, xm in [(hc, xi), (one, xi), (hc[:100], xi[:100]),
                    (hc[:256 * 7 + 3], xi[:256 * 7 + 3]),
                    (hc[:5003], xi[:5003, :3]), (hc, xi[:, :1]),
                    (hc[15::16], xi[15::16])]:
        ids, xm = ids.contiguous(), xm.contiguous()
        assert torch.equal(ss.sorted_segment_max_u32(ids, xm),
                           ss.sorted_segment_max_u32_plain(ids, xm))
        n_max += 1
    for c, window in [(64, 8), (16, 8), (3, 1), (64, ss.MAX_WINDOW)]:
        xw = xi[:, :c].contiguous()
        assert torch.equal(ss.sorted_segment_max_window(hc, xw, window),
                           ss.sorted_segment_max_window_plain(hc, xw, window))
    after = _cuda.launch_counts()
    assert after["fused_simplex_pack"] == before["fused_simplex_pack"] + 1
    assert after["sorted_segment_scan"] == \
        before["sorted_segment_scan"] + n_scans
    assert after["seg_sum_tails"] == before["seg_sum_tails"] + 2
    assert after["sorted_segment_max_u32"] == \
        before["sorted_segment_max_u32"] + n_max
    assert after["sorted_segment_max_window"] == \
        before["sorted_segment_max_window"] + 4


@pytest.mark.parametrize("name,kernel", [
    ("void seg_max_lookback<4>(int const*, unsigned int const*, unsigned "
     "int*, unsigned long long*, unsigned int*, long, int, int, int)",
     "sorted_segment_max_u32"),
    ("void seg_max_lookback<1>(int const*, unsigned int const*, unsigned "
     "int*, unsigned long long*, unsigned int*, long, int, int, int)",
     "sorted_segment_max_u32"),
    ("void seg_scan_lookback<0, 4, false>(int const*, float const*, float*, "
     "unsigned long long*, float*, long, int, int, int)",
     "sorted_segment_scan"),
    ("void seg_scan_lookback<4, 1, true>(int const*, unsigned int const*, "
     "unsigned int*, unsigned long long*, unsigned int*, long, int, int, int)",
     "sorted_segment_scan"),
    ("void seg_sum_tails_scan<4>(int const*, float const*, float*, unsigned "
     "long long*, float*, long, int, int, int)", "seg_sum_tails"),
    ("void (anonymous namespace)::seg_max_window_kernel<int4>(int const*, "
     "int4 const*, int4*, long, int, int)", "sorted_segment_max_window"),
    ("simplex_kernel(float const*, unsigned char const*, long, long*, "
     "float*)", "fused_simplex_pack"),
    ("void (anonymous namespace)::lattice_conv_kernel<float, 128>(float "
     "const*, long const*, long, __nv_bfloat16 const*, float const*, long "
     "const*, long, float*, int, int, int, int, int)", "lattice_conv"),
    ("void (anonymous namespace)::masked_gn_sum_kernel<4>(float const*, "
     "long const*, long, (anonymous namespace)::Layout, float*)",
     "masked_gn_relu"),
    ("void (anonymous namespace)::masked_gn_relu_out_kernel<1>(float const*, "
     "long const*, long, (anonymous namespace)::Layout, float const*, float "
     "const*, float, float const*, float*, float*)", "masked_gn_relu"),
    ("void (anonymous namespace)::masked_gn_bwd_dx_kernel<4>(float const*, "
     "float const*, long const*, long, (anonymous namespace)::Layout, ...)",
     "masked_gn_relu_backward"),
    ("void (anonymous namespace)::lattice_conv_dx_kernel<float, 64>(float "
     "const*, long const*, long, __nv_bfloat16 const*, long const*, long, "
     "float*, int, int, int, int, int)", "lattice_conv_dx"),
    ("void (anonymous namespace)::lattice_conv_dw_kernel<float, 128>(float "
     "const*, long const*, long, float const*, long const*, long, float*, "
     "int, int, int, int, int, int)", "lattice_conv_dw"),
    ("void (anonymous namespace)::lattice_conv_dw_sum_kernel<float>(float "
     "const*, long const*, long, float*, long, int, int, int)",
     "lattice_conv_dw"),
    ("Memset (Device)", None),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, ...)", None),
])
def test_chip_smoke_assigns_kernel_names(name, kernel):
    """The profiler's kernel names map to K1-K7 by name: K4's look-back
    kernel is never counted as K2's, nor K2's as K4's, nor K7's backward
    as its forward."""
    assert chip_smoke.hand_written(name) == kernel


def test_chip_smoke_counts_a_call_by_its_first_kernel():
    """A replay's launches counted by name: a wrapper that launches several
    kernels (K3, K7's forward and backward) counts one a call."""
    names = (["void (anonymous namespace)::masked_gn_sum_kernel<4>(x)",
              "void (anonymous namespace)::masked_gn_sq_kernel<4>(x)",
              "void (anonymous namespace)::masked_gn_relu_out_kernel<4>(x)"]
             * 2
             + ["void (anonymous namespace)::masked_gn_bwd_sums_kernel<4>(x)",
                "void (anonymous namespace)::masked_gn_bwd_dx_kernel<4>(x)",
                "void seg_sum_tails_scan<4>(x)",
                "void seg_sum_tails_gather(x)"])
    events = [types.SimpleNamespace(name=n) for n in names]
    got = chip_smoke.traced_launches(events, 1)
    assert got["masked_gn_relu"] == 2
    assert got["masked_gn_relu_backward"] == 1
    assert got["seg_sum_tails"] == 1
    assert got["lattice_conv"] == 0


def test_chip_smoke_counts_k8_apart_from_k6():
    """K8's dX is one kernel a call, its dW two (counted by the first);
    neither is counted as K6."""
    names = ["void (anonymous namespace)::lattice_conv_kernel<float, 64>(x)",
             "void (anonymous namespace)::lattice_conv_dx_kernel<float, 64>"
             "(x)",
             "void (anonymous namespace)::lattice_conv_dw_kernel<float, 128>"
             "(x)",
             "void (anonymous namespace)::lattice_conv_dw_sum_kernel<float>"
             "(x)"] * 3
    events = [types.SimpleNamespace(name=n) for n in names]
    got = chip_smoke.traced_launches(events, 3)
    assert got["lattice_conv"] == 1
    assert got["lattice_conv_dx"] == 1
    assert got["lattice_conv_dw"] == 1


def test_cpu_path_does_not_count_launches():
    before = _cuda.launch_counts()
    ss.sorted_segment_scan(torch.zeros(16, dtype=torch.int32),
                           torch.ones(16, 1, dtype=torch.int32), "sum")
    fs.fused_simplex_pack(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool))
    assert _cuda.launch_counts() == before
