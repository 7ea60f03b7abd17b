"""The bf16 lattice convolution as kernel K6 (``ops/lattice_ops``:
``_LatticeConvBf16``, ``lattice_conv_gemm``) and its backward as kernel K8
(``lattice_conv_backward``: ``lattice_conv_dx``, ``lattice_conv_dw``).

On the CPU the Function runs K6's and K8's plain versions; its forward and
its gradients for values, weight and bias must equal, bit for bit, those of
the plain path that ``lattice_conv`` takes on the CPU (``gather_rowified``
+ ``matmul_f32`` + bias + ``mask_rows`` under autograd), with the rows'
remat on and off, at widths that are not multiples of 16.  The tests marked
``cuda`` hold K6 and K8 against their plain versions and float64 bounds on
the card at the main path's shapes.  Nothing here imports JAX."""

import math

import pytest
import torch

from temporal_latticenet_tpu_torch.ops import _cuda
from temporal_latticenet_tpu_torch.ops import lattice_ops as lo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small products then sum in one fixed
    order, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(rows, cin, cout, count, seed=0, device="cpu",
              dtype=torch.float32, bias=True, edges=False):
    """Values zero outside [1, count) (the ``mask_rows`` invariant), a
    table whose absent neighbors read row 0, a weight and a bias.  With
    ``edges``, a twentieth of the table's entries are -1 and row 0 has
    occupied neighbors."""
    g = torch.Generator().manual_seed(seed)
    values = torch.randn(rows, cin, generator=g)
    keep = (torch.arange(rows) > 0) & (torch.arange(rows) < count)
    values = torch.where(keep[:, None], values, torch.zeros(()))
    idx8 = torch.randint(0, rows, (rows, 8), generator=g)
    idx8 = torch.where(torch.rand(rows, 8, generator=g) < 0.3,
                       torch.zeros_like(idx8), idx8)
    if edges:
        idx8 = torch.where(torch.rand(rows, 8, generator=g) < 0.05,
                           torch.full_like(idx8, -1), idx8)
        idx8[0] = torch.randint(1, count, (8,), generator=g)
    idx = torch.cat([idx8, torch.arange(rows)[:, None]], dim=1)
    nbr = lo.NeighborTable(idx=idx.to(device), found=(idx > 0).to(device))
    weight = torch.randn(9 * cin, cout, generator=g) / (9 * cin) ** 0.5
    b = torch.randn(cout, generator=g) * 0.1 if bias else None
    return (values.to(device=device, dtype=dtype), nbr, weight.to(device),
            None if b is None else b.to(device),
            torch.tensor(count, device=device))


def _grads(fn, values, weight, bias, dy):
    values = values.detach().requires_grad_()
    weight = weight.detach().requires_grad_()
    leaves = [values, weight]
    if bias is not None:
        bias = bias.detach().requires_grad_()
        leaves.append(bias)
    out = fn(values, weight, bias)
    return [out] + list(torch.autograd.grad(out, leaves, dy))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("rows,cin,cout,count,bias", [
    (300, 16, 24, 241, True),
    (257, 12, 20, 200, False),    # widths off the multiples of 16
    (129, 5, 3, 129, True),       # every row occupied, narrow odd widths
])
def test_function_equals_plain_path(rows, cin, cout, count, bias, remat):
    values, nbr, weight, b, cnt = _operands(rows, cin, cout, count,
                                            bias=bias)
    dy = torch.randn(rows, cout, generator=torch.Generator().manual_seed(1))

    def plain(v, w, bb):
        with lo.remat_conv_rows(remat):
            return lo.lattice_conv(v, nbr, w, cnt, bb, torch.bfloat16)

    def function(v, w, bb):
        return lo._LatticeConvBf16.apply(v, w, bb, nbr, cnt)

    want = _grads(plain, values, weight, b, dy)
    got = _grads(function, values, weight, b, dy)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_function_takes_int_count_and_bf16_values():
    values, nbr, weight, b, _ = _operands(200, 8, 16, 150)
    values = values.to(torch.bfloat16)
    dy = torch.randn(200, 16, generator=torch.Generator().manual_seed(2))
    want = _grads(lambda v, w, bb: lo.lattice_conv(v, nbr, w, 150, bb,
                                                   torch.bfloat16),
                  values, weight, b, dy)
    got = _grads(lambda v, w, bb: lo._LatticeConvBf16.apply(v, w, bb,
                                                             nbr, 150),
                 values, weight, b, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_function_routes_taps_adjoint_through_gather_backward(monkeypatch):
    """The Function's 8 taps go back through ``_Gather8Sym.backward``, as
    the plain path's do: a change there (a negated adjoint, say) reaches
    both alike."""
    values, nbr, weight, b, cnt = _operands(220, 8, 12, 180)
    dy = torch.randn(220, 12, generator=torch.Generator().manual_seed(3))
    real = lo._Gather8Sym.backward

    def negated(ctx, dg):
        g, none = real(ctx, dg)
        return -g, none

    def both():
        return [_grads(fn, values, weight, b, dy)[1] for fn in (
            lambda v, w, bb: lo.lattice_conv(v, nbr, w, cnt, bb,
                                             torch.bfloat16),
            lambda v, w, bb: lo._LatticeConvBf16.apply(v, w, bb, nbr, cnt))]

    plain, function = both()
    monkeypatch.setattr(lo._Gather8Sym, "backward", staticmethod(negated))
    plain_neg, function_neg = both()
    assert torch.equal(function_neg, plain_neg)
    assert not torch.equal(function_neg, function)
    assert torch.equal(function, plain)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    values, nbr, weight, b, cnt = _operands(190, 10, 12, 100)
    before = _cuda.launch_counts()
    got = lo.lattice_conv_gemm(values, nbr, weight, b, cnt)
    assert _cuda.launch_counts() == before
    want = lo.lattice_conv(values, nbr, weight, cnt, b, torch.bfloat16)
    assert torch.equal(got, want)
    assert not got[0].any() and not got[100:].any()


@pytest.mark.parametrize("cout,width", [(3, 32), (32, 32), (64, 64),
                                        (96, 96), (128, 128), (192, 96),
                                        (256, 128), (100, 128)])
def test_tile_width(cout, width):
    assert lo._tile_width(cout) == width


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rows,cin,cout,count,edges", [
    (300, 16, 24, 241, False),
    (257, 12, 20, 200, True),     # -1 entries, row 0 with neighbors
    (129, 5, 3, 129, False),      # every row occupied, narrow odd widths
])
def test_backward_plain_equals_autograd(rows, cin, cout, count, edges,
                                        bias):
    """``lattice_conv_backward_plain`` gives the plain path's gradients
    under autograd bit for bit, each where asked for and None elsewhere."""
    values, nbr, weight, b, cnt = _operands(rows, cin, cout, count,
                                            bias=bias, edges=edges)
    dy = torch.randn(rows, cout, generator=torch.Generator().manual_seed(4))
    _, *want = _grads(lambda v, w, bb: lo.lattice_conv(
        v, nbr, w, cnt, bb, torch.bfloat16), values, weight, b, dy)
    got = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                         (True, True, bias))
    assert (got[2] is None) == (not bias)
    for g, w in zip([x for x in got if x is not None], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    only = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                          (False, True, False))
    assert only[0] is None and only[2] is None
    assert torch.equal(only[1], want[1])


def _split_cases():
    g = torch.Generator().manual_seed(5)
    normal = torch.randn(4096, generator=g)
    scales = 2.0 ** torch.randint(-100, 100, (4096,), generator=g)
    ulp = torch.finfo(torch.float32).eps
    # bf16 values and the float32 values next to their rounding ties
    b = torch.randn(1024, generator=g).to(torch.bfloat16).float()
    half = b.abs() * 2.0 ** -8
    ties = torch.cat([b + half, b - half, b + half * (1 + ulp),
                      b + half * (1 - ulp), b - half * (1 + ulp)])
    big = torch.finfo(torch.float32).max
    return {
        "random": normal * scales,
        "powers_of_two": torch.cat([2.0 ** torch.arange(-110, 128.0),
                                    -(2.0 ** torch.arange(-110, 128.0))]),
        "rounding_ties": ties,
        "zeros": torch.tensor([0.0, -0.0, 1.0, -1.0]),
        "large": torch.tensor([big, -big, big * 0.75, 3.3e38, -3.39e38,
                               torch.nextafter(torch.tensor(big),
                                               torch.tensor(0.0)).item()]),
        "bf16_subnormal_steps": torch.arange(-300, 300.0) * 2.0 ** -133,
    }


@pytest.mark.parametrize("case", sorted(_split_cases()))
def test_bf16_split3_is_exact(case):
    """The three bf16 parts of K8's split add up to the float32 value
    exactly (in float64, and in float32 in the order hi + mid + lo); hi is
    the value's top 16 bits."""
    x = _split_cases()[case].to(torch.float32)
    parts = lo.bf16_split3(x)
    hi, mid, low = (p.float() for p in parts)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32) & -65536)
    assert torch.equal(hi.double() + mid.double() + low.double(), x.double())
    assert torch.equal((hi + mid) + low, x)
    assert bool(torch.isfinite(torch.stack([hi, mid, low])).all())


def _bad_k8_args():
    """(wrapper, keyword arguments): each breaks one thing the kernels do
    not take; the rest are well-formed CPU tensors, which they refuse
    too."""
    rows, cin, cout = 64, 8, 16
    dy = torch.zeros(rows, cout)
    idx = torch.zeros(rows, 9, dtype=torch.int64)
    nbr = lo.NeighborTable(idx, idx > 0)
    w = torch.zeros(9 * cin, cout, dtype=torch.bfloat16)
    v = torch.zeros(rows, cin)
    dx = dict(dy=dy, nbr=nbr, weight=w, count=10, dtype=torch.float32)
    dw = dict(dy=dy, values=v, nbr=nbr, count=10, dtype=torch.float32)
    bad_nbr = [lo.NeighborTable(idx.to(torch.int32), idx > 0),
               lo.NeighborTable(idx[:, :7], idx[:, :7] > 0),
               lo.NeighborTable(idx[1:], idx[1:] > 0),
               lo.NeighborTable(idx.t().contiguous().t(), idx > 0)]
    cases = [("dx", dict(dx))]
    for name, base in (("dx", dx), ("dw", dw)):
        cases += [(name, dict(base, dy=dy.double())),
                  (name, dict(base, dy=dy[:, :-1].contiguous()[None])),
                  (name, dict(base, dy=torch.zeros(cout, rows).t())),
                  (name, dict(base, dtype=torch.float16)),
                  (name, dict(base, count=torch.tensor(1.5))),
                  (name, dict(base, count=torch.tensor([1, 2])))]
        cases += [(name, dict(base, nbr=n)) for n in bad_nbr]
    cases += [("dx", dict(dx, weight=w.float())),
              ("dx", dict(dx, weight=w[:, :-1].contiguous())),
              ("dx", dict(dx, weight=w[:-1].contiguous())),
              ("dw", dict(dw)),
              ("dw", dict(dw, values=v.long())),
              ("dw", dict(dw, values=v[1:].contiguous())),
              ("dw", dict(dw, values=torch.zeros(cin, rows).t()))]
    return cases


@pytest.mark.parametrize("i", range(len(_bad_k8_args())))
def test_k8_wrappers_check_arguments(i):
    name, kw = _bad_k8_args()[i]
    fn = lo.lattice_conv_dx if name == "dx" else lo.lattice_conv_dw
    before = _cuda.launch_counts()
    with pytest.raises(ValueError):
        fn(**kw)
    assert _cuda.launch_counts() == before


def test_cpu_backward_is_the_plain_version_and_launches_nothing():
    values, nbr, weight, b, cnt = _operands(190, 10, 12, 100, edges=True)
    dy = torch.randn(190, 12, generator=torch.Generator().manual_seed(6))
    w16 = weight.to(torch.bfloat16)
    before = _cuda.launch_counts()
    got = lo.lattice_conv_backward(dy, values, nbr, w16, cnt,
                                   (True, True, True), torch.float32)
    assert _cuda.launch_counts() == before
    want = lo.lattice_conv_backward_plain(dy, values, nbr, w16, cnt)
    assert got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1].float())


@pytest.mark.parametrize("rows,cin,cout,count", [
    (1000, 33, 96, 999), (3001, 13, 7, 2999), (1024, 16, 16, 700),
    (2048, 64, 64, 1500)])
def test_k8_bounds_hold_the_plain_version_and_reject_planted_faults(
        rows, cin, cout, count):
    """``chip_smoke.k8_bounds``, the bounds the card tests and the smoke
    script hold K8 to, admit the plain version's dX and dW on every entry
    and reject, each on a share of the entries, the outputs of a kernel
    that kept only the top bf16 part of the cotangent or dropped one
    32-row step (``chip_smoke.k8_planted``)."""
    import chip_smoke

    values, nbr, weight, _, cnt = _operands(rows, cin, cout, count,
                                            seed=rows, edges=True)
    weight = weight.to(torch.bfloat16)
    dy = torch.randn(rows, cout, generator=torch.Generator().manual_seed(9))
    bounds = chip_smoke.k8_bounds(dy, values, nbr, weight, cnt)
    plain = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                           (True, True, False))
    for got, (low, high) in zip(plain[:2], bounds):
        assert chip_smoke.outside(got, low, high) == 0
    planted = chip_smoke.k8_planted(dy, values, nbr, weight, cnt)
    for name, outs in planted.items():
        for got, (low, high) in zip(outs, bounds):
            assert chip_smoke.outside(got, low, high) > 0, name


# 1 + 2^-9 + 2^-18 and 1 + 2^-9: their difference is the split's lo part
_X, _Y = 1 + 2.0 ** -9 + 2.0 ** -18, 1 + 2.0 ** -9


def _cancelling_case(device="cpu"):
    """Operands whose every float32 sum is exact and whose gradients need
    all three parts of the cotangent's split: values 1 on the occupied
    rows, a weight of +1 (output 0) and -1 (output 1), and a cotangent
    (x, y) on row 1 and (-y, -x) on row count - 1, so that the center
    tap's dW and each tap's product in dX are +-2^-18 = x - y."""
    rows, cin, cout, count = 1024, 16, 16, 700
    values, nbr, _, _, cnt = _operands(rows, cin, cout, count, seed=3,
                                       device=device, edges=True)
    values = (values != 0).float()
    weight = torch.zeros(9 * cin, cout, device=device)
    weight[:, 0], weight[:, 1] = 1.0, -1.0
    dy = torch.zeros(rows, cout, device=device)
    dy[1, :2] = torch.tensor([_X, _Y])
    dy[count - 1, :2] = torch.tensor([-_Y, -_X])
    return dy, values, nbr, weight.to(torch.bfloat16), cnt


def test_cancelling_cotangent_needs_every_part_of_the_split():
    """On ``_cancelling_case`` the plain version's center-tap dW is
    +-2^-18 and its dX is a multiple of 2^-18 where a tap reads rows 1 or
    count - 1; a cotangent of its top one or two bf16 parts gives zero
    there."""
    dy, values, nbr, weight, cnt = _cancelling_case()
    cin = values.shape[1]
    dx, dw, _ = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                               (True, True, False))
    lo_part = 2.0 ** -18
    center = dw.float()[8 * cin:]
    assert bool((center[:, 0] == lo_part).all())
    assert bool((center[:, 1] == -lo_part).all())
    assert bool(dx.any()) and bool((dx % lo_part == 0).all())
    hi, mid, _ = (p.float() for p in lo.bf16_split3(dy))
    for part in (hi, hi + mid):
        dx_p, dw_p, _ = lo.lattice_conv_backward_plain(
            part, values, nbr, weight, cnt, (True, True, False))
        assert not dx_p.any() and not dw_p.float()[8 * cin:].any()


@pytest.mark.parametrize("rows,cin,cout,sms", [
    (49152, 128, 64, 132), (49152, 64, 64, 132), (49152, 192, 192, 132),
    (24576, 64, 128, 132), (24576, 128, 128, 132), (24576, 256, 128, 132),
    (12288, 128, 256, 132), (12288, 128, 128, 132), (12288, 256, 128, 132),
    (3001, 13, 7, 132), (100, 8, 16, 132), (0, 8, 16, 132),
    (49152, 64, 64, 1)])
def test_dw_chunks_cover_the_rows(rows, cin, cout, sms):
    """Whole 32-row steps a chunk, every row in exactly one chunk, no empty
    chunk, partials within half the bytes of the bf16 rows, and blocks for
    about two waves where the memory allows."""
    chunk_rows, chunks = lo._dw_chunks(rows, cin, cout, sms)
    assert chunk_rows > 0 and chunk_rows % 32 == 0
    assert chunks * chunk_rows >= rows > (chunks - 1) * chunk_rows
    assert chunks * 9 * cin * cout * 4 <= max(rows, 256) * 9 * cin
    tiles = math.ceil(9 * cin / 128) * math.ceil(cout / lo._tile_width(cout))
    if rows >= 49152 and sms > 1:
        assert 2 * sms <= chunks * tiles


@pytest.mark.parametrize("cin,width", [(5, 32), (32, 32), (33, 64),
                                       (64, 64), (256, 64)])
def test_dx_tile_width(cin, width):
    assert lo._dx_tile_width(cin) == width


# ---------------------------------------------------------------------------
# K6 on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K6 has no CPU mode)")
    return torch.device("cuda")


def _reference(values, nbr, weight, bias):
    """The exact sum of the bf16 products in float64, and the sum of their
    magnitudes (with the bias's), per output."""
    rows = lo.gather_rowified(values.to(torch.bfloat16), nbr).double()
    w = weight.to(torch.bfloat16).double()
    exact = rows @ w
    mag = rows.abs() @ w.abs()
    if bias is not None:
        exact = exact + bias.double()
        mag = mag + bias.double().abs()
    return exact, mag


# (rows, Cin, Cout, count): the main path's pairs at the level capacities
# 49,152 / 24,576 / 12,288 with occupied prefixes below them, an odd width,
# and the narrow widths of the smaller configurations
CARD_SHAPES = [
    (49152, 64, 64, 40417), (49152, 192, 192, 40417),
    (24576, 64, 128, 20311), (24576, 128, 128, 20311),
    (24576, 256, 128, 20311), (12288, 128, 256, 7001),
    (12288, 128, 128, 7001), (12288, 256, 128, 7001),
    (3001, 13, 7, 2999), (1024, 16, 16, 700), (1024, 32, 16, 1024),
]


@pytest.mark.cuda
def test_k6_matches_plain_on_card(cuda_device):
    dev = cuda_device
    before = _cuda.launch_counts()["lattice_conv"]
    calls = 0
    for i, (rows, cin, cout, count) in enumerate(CARD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            values, nbr, weight, b, cnt = _operands(
                rows, cin, cout, count, seed=i, device=dev, dtype=dtype,
                bias=i % 2 == 0)
            got = lo.lattice_conv_gemm(values, nbr, weight, b, cnt)
            calls += 1
            exact, mag = _reference(values, nbr, weight, b)
            n = 9 * cin + (b is not None)      # products, and the bias
            tol = (n + 1) * 2.0 ** -24 * mag
            live = (torch.arange(rows, device=dev) > 0) \
                & (torch.arange(rows, device=dev) < count)
            err = (got.double() - exact).abs()
            assert bool((err[live] <= tol[live]).all()), \
                (rows, cin, cout, dtype, float(err.max()))
            # rows 0 and from count up exactly zero
            assert torch.equal(got[~live], torch.zeros_like(got[~live]))
            plain = lo.lattice_conv_gemm_plain(values, nbr, weight, b,
                                               cnt)
            assert bool(((got.double() - plain.double()).abs()
                         <= 2 * tol).all())
            # bit-equal from call to call
            assert torch.equal(got, lo.lattice_conv_gemm(values, nbr,
                                                         weight, b, cnt))
            calls += 1
    assert _cuda.launch_counts()["lattice_conv"] == before + calls


@pytest.mark.cuda
def test_k6_graph_replay_equals_eager(cuda_device):
    dev = cuda_device
    values, nbr, weight, b, cnt = _operands(24576, 128, 128, 20311,
                                            device=dev)
    eager = lo.lattice_conv_gemm(values, nbr, weight, b, cnt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lo.lattice_conv_gemm(values, nbr, weight, b, cnt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _cuda.launch_counts()["lattice_conv"]
    with torch.cuda.graph(graph):
        captured = lo.lattice_conv_gemm(values, nbr, weight, b, cnt)
    assert _cuda.launch_counts()["lattice_conv"] == before
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    # the count is read on the device at each replay
    cnt.fill_(1000)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured,
                       lo.lattice_conv_gemm(values, nbr, weight, b, cnt))
    assert not captured[1000:].any()


@pytest.mark.cuda
def test_function_gradients_on_card(cuda_device):
    """The Function's gradients on the card (kernel K8) against the plain
    path's on the card: the same float32 products summed in another order.
    The values' gradient, rounded to bf16 after each tap's product and
    after the taps' sum, both within the dX half of ``chip_smoke.
    k8_bounds`` ((n + 1) 2^-24 sum|terms| before each rounding, n at most
    3 Cout + 8); the weight's, the bias's and the forward (within K6's
    bound) close."""
    import chip_smoke

    dev = cuda_device
    values, nbr, weight, b, cnt = _operands(12288, 128, 64, 9001,
                                            device=dev)
    dy = torch.randn(12288, 64, device=dev)

    def plain(v, w, bb):
        v = v.to(torch.bfloat16)
        return lo.mask_rows(lo._gather_matmul(v, nbr, w, torch.bfloat16)
                            + bb, cnt)

    got = _grads(lambda v, w, bb: lo.lattice_conv(v, nbr, w, cnt, bb,
                                                  torch.bfloat16),
                 values, weight, b, dy)
    want = _grads(plain, values, weight, b, dy)
    low, high = chip_smoke.k8_bounds(dy, values, nbr, weight, cnt)[0]
    assert got[1].dtype == want[1].dtype
    for x in (got[1].double(), want[1].double()):
        assert bool(((x >= low) & (x <= high)).all())
    # the weight's and the bias's gradients are rounded to bf16 (as the
    # plain path's upcasts' backwards round them): a different order of
    # the float32 sums may move a rounding by one bf16 step, 2^-8 of the
    # value, and more where the sums cancel
    for g, w in zip(got[::2] + got[3:], want[::2] + want[3:]):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# K8 (K6's backward) on the card
# ---------------------------------------------------------------------------

# (rows, Cin, Cout, count): the nine width pairs of the main path's step at
# the level capacities, then narrow and odd widths (one element at a time)
K8_SHAPES = [
    (49152, 128, 64, 40417), (49152, 64, 64, 40417),
    (49152, 192, 192, 40417), (24576, 64, 128, 20311),
    (24576, 128, 128, 20311), (24576, 256, 128, 20311),
    (12288, 128, 256, 7001), (12288, 128, 128, 7001),
    (12288, 256, 128, 7001), (3001, 13, 7, 2999), (1024, 16, 16, 700),
    (1000, 33, 96, 999),
]


def _k8_case(i, dev, dtype=torch.float32):
    rows, cin, cout, count = K8_SHAPES[i]
    values, nbr, weight, _, cnt = _operands(rows, cin, cout, count, seed=i,
                                            device=dev, dtype=dtype,
                                            edges=True)
    dy = torch.randn(rows, cout, generator=torch.Generator().manual_seed(i)
                     ).to(dev)
    return values, nbr, weight.to(torch.bfloat16), cnt, dy


def _bf16_steps(a, b):
    """How many bf16 values apart the bf16-valued ``a`` and ``b`` are."""
    def order(x):
        i = x.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(a) - order(b)).abs()


def test_bf16_steps():
    a = torch.tensor([1.0, 1.0, -1.0, 0.0, 2.0 ** -133, 1.0])
    b = torch.tensor([1.0, 1.0078125, -1.0078125, -0.0, -(2.0 ** -133), 2.0])
    assert _bf16_steps(a, b).tolist() == [0, 1, 1, 0, 2, 128]


@pytest.mark.cuda
def test_k8_within_bounds_on_card(cuda_device):
    """dX and dW within ``chip_smoke.k8_bounds`` (dX: (n + 1) 2^-24
    sum|terms| of the float64 sums before each bf16 rounding of the plain
    path; dW: a float32 sum's spread about its exact sum, one or two bf16
    values wide where the sum does not cancel), as the plain version on
    the card is, on every row (row 0 reads its neighbors; -1 entries read
    nothing), and the planted faults of ``chip_smoke.k8_planted`` outside
    them; bit-equal from call to call; one launch counted a call."""
    import chip_smoke

    dev = cuda_device
    before = _cuda.launch_counts()
    calls = 0
    for i in range(len(K8_SHAPES)):
        dtype = torch.bfloat16 if i % 4 == 3 else torch.float32
        values, nbr, weight, cnt, dy = _k8_case(i, dev, dtype)
        w_dtype = torch.bfloat16 if i % 3 == 2 else torch.float32
        (x_lo, x_hi), (w_lo, w_hi) = chip_smoke.k8_bounds(dy, values, nbr,
                                                          weight, cnt)
        plain = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                               (True, True, False))
        runs = [(lo.lattice_conv_dx(dy, nbr, weight, cnt, dtype),
                 lo.lattice_conv_dw(dy, values, nbr, cnt, w_dtype))
                for _ in range(2)]
        calls += 2
        dx, dw = runs[0]
        assert dx.dtype == dtype and dw.dtype == w_dtype
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        for got, low, high, want in ((dx, x_lo, x_hi, plain[0]),
                                     (dw, w_lo, w_hi, plain[1])):
            for x in (got.double(), want.double()):
                assert bool(((x >= low) & (x <= high)).all()), \
                    (K8_SHAPES[i], float((x - low).min()),
                     float((high - x).min()))
        # so dW is within one bf16 step of the plain version wherever the
        # bounds hold no more than two bf16 values: where its sum does not
        # cancel
        narrow = _bf16_steps(w_lo, w_hi) <= 1
        assert bool((_bf16_steps(dw, plain[1])[narrow] <= 1).all())
        if dtype == torch.float32:
            planted = chip_smoke.k8_planted(dy, values, nbr, weight, cnt)
            for name, outs in planted.items():
                for got, (low, high) in zip(outs, ((x_lo, x_hi),
                                                   (w_lo, w_hi))):
                    assert chip_smoke.outside(got, low, high) > 0, \
                        (K8_SHAPES[i], name)
    after = _cuda.launch_counts()
    assert after["lattice_conv_dx"] == before["lattice_conv_dx"] + calls
    assert after["lattice_conv_dw"] == before["lattice_conv_dw"] + calls


@pytest.mark.cuda
def test_k8_carries_every_part_of_the_cotangent_on_card(cuda_device):
    """On ``_cancelling_case``, where every float32 sum is exact and the
    gradients are the split's lo part (a kernel that drops lo, or mid and
    lo, gives zero there), K8 equals the plain version on the CPU bit for
    bit."""
    dy, values, nbr, weight, cnt = _cancelling_case()
    want = lo.lattice_conv_backward_plain(dy, values, nbr, weight, cnt,
                                          (True, True, False))
    dev = cuda_device
    nbr_d = lo.NeighborTable(nbr.idx.to(dev), nbr.found.to(dev))
    dx = lo.lattice_conv_dx(dy.to(dev), nbr_d, weight.to(dev),
                            cnt.to(dev), torch.float32)
    dw = lo.lattice_conv_dw(dy.to(dev), values.to(dev), nbr_d, cnt.to(dev),
                            torch.bfloat16)
    assert torch.equal(dx.cpu(), want[0]) and torch.equal(dw.cpu(), want[1])


@pytest.mark.cuda
def test_k8_graph_replay_equals_eager(cuda_device):
    dev = cuda_device
    values, nbr, weight, cnt, dy = _k8_case(2, dev)

    def both():
        return (lo.lattice_conv_dx(dy, nbr, weight, cnt, torch.float32),
                lo.lattice_conv_dw(dy, values, nbr, cnt, torch.float32))

    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _cuda.launch_counts()
    with torch.cuda.graph(graph):
        captured = both()
    assert _cuda.launch_counts() == before
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, eager))
    # the count is read on the device at each replay
    cnt.fill_(1000)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, both()))


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 2, 8])
def test_k8_backward_allocates_no_rows(cuda_device, i):
    """One backward of the Function allocates less than one (C, 9 Cin) bf16
    buffer at its peak: the gradients and dW's partials, no rows."""
    dev = cuda_device
    values, nbr, weight, cnt, dy = _k8_case(i, dev)
    values = values.requires_grad_()
    weight = weight.float().requires_grad_()
    out = lo._LatticeConvBf16.apply(values, weight, None, nbr, cnt)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _cuda.launch_counts()
    torch.autograd.grad(out, [values, weight], dy)
    torch.cuda.synchronize()
    rows, cin = values.shape
    assert torch.cuda.max_memory_allocated() - base < rows * 9 * cin * 2
    after = _cuda.launch_counts()
    assert after["lattice_conv_dx"] == before["lattice_conv_dx"] + 1
    assert after["lattice_conv_dw"] == before["lattice_conv_dw"] + 1
