"""The bf16 lattice convolution as kernel K6 (``ops/lattice_ops``:
``_LatticeConvBf16``, ``lattice_conv_gemm``).

On the CPU the Function runs K6's plain version; its forward and its
gradients for values, weight and bias must equal, bit for bit, those of the
plain path that ``lattice_conv`` takes on the CPU (``gather_rowified`` +
``matmul_f32`` + bias + ``mask_rows`` under autograd), with the rows'
remat on and off, at widths that are not multiples of 16.  The test marked
``cuda`` holds K6 against its plain version on the card at the main path's
shapes.  Nothing here imports JAX."""

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
              dtype=torch.float32, bias=True):
    """Values zero outside [1, count) (the ``mask_rows`` invariant), a
    table whose absent neighbors read row 0, a weight and a bias."""
    g = torch.Generator().manual_seed(seed)
    values = torch.randn(rows, cin, generator=g)
    keep = (torch.arange(rows) > 0) & (torch.arange(rows) < count)
    values = torch.where(keep[:, None], values, torch.zeros(()))
    idx8 = torch.randint(0, rows, (rows, 8), generator=g)
    idx8 = torch.where(torch.rand(rows, 8, generator=g) < 0.3,
                       torch.zeros_like(idx8), idx8)
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
    """The Function's gradients on the card against the plain path's on
    the card: the same float32 products, so equal up to the order of the
    sums (and the forward within K6's bound)."""
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
    # the values' and the weight's gradients are rounded to bf16 (as the
    # plain path's upcasts' backwards round them): a different order of
    # the float32 sums may move a rounding by one bf16 step, 2^-8 of the
    # value, and more where the sums cancel
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=1e-3)
