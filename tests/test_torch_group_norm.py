"""The masked GroupNorm and its ReLU as kernel K7 (``ops/group_norm``:
``_MaskedGnRelu``, ``masked_gn_relu_forward``, ``masked_gn_relu_backward``).

On the CPU the Function runs K7's plain versions; its forward and its
gradients for x, weight and bias must equal, bit for bit, those of the
plain path the model took before K7 (``MaskedGroupNorm`` + ``torch.relu``
under autograd), at the model's widths and at narrow ones, for counts of 1,
2, a middle value and the capacity, with garbage in row 0 and the rows from
the count up, and with the count as an int or a tensor.  The tests marked
``cuda`` hold K7 on the card to the exact (float64) GroupNorm at the main
path's shapes, within bounds derived from (n + 1) 2^-24 sum|x| for each
float32 sum of n terms, and to the plain path on the card; then call to
call, under CUDA-graph replay and under the sync-debug mode.  Nothing here
imports JAX."""

import pytest
import torch

from temporal_latticenet_tpu_torch.models import blocks
from temporal_latticenet_tpu_torch.ops import _cuda
from temporal_latticenet_tpu_torch.ops import group_norm as gnm

EPS = 1e-5
U = 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the small sums then run in one fixed order,
    beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(rows, c, count, seed=0, device="cpu", integer=False):
    """x with garbage (large, finite) in row 0 and from ``count`` up, a
    weight, a bias and a cotangent; ``integer``: small whole numbers in x,
    the weight and dy, whose float32 sums are exact in any order."""
    g = torch.Generator().manual_seed(seed)
    live = gnm.valid_rows(rows, count, "cpu")
    if integer:
        half = torch.randint(-8, 9, (rows, c), generator=g).float()
        # each group's valid rows sum to zero: row i and the last-but-i
        # valid row hold opposite values
        n = int(live.sum())
        x = torch.zeros(rows, c)
        x[1:1 + n // 2] = half[1:1 + n // 2]
        x[1 + n - n // 2:1 + n] = -half[1:1 + n // 2].flip(0)
        weight = torch.randint(-2, 3, (c,), generator=g).float()
        dy = torch.randint(-4, 5, (rows, c), generator=g).float()
    else:
        x = torch.randn(rows, c, generator=g) * 1.5 + 0.3
        weight = torch.randn(c, generator=g)
        dy = torch.randn(rows, c, generator=g)
    x = torch.where(live[:, None], x, 100 * torch.randn(rows, c, generator=g))
    bias = torch.randn(c, generator=g) * 0.5
    cnt = torch.tensor(count, device=device)
    return (x.to(device), weight.to(device), bias.to(device), dy.to(device),
            cnt)


def _grads(fn, x, weight, bias, dy):
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    out = fn(*leaves)
    return [out] + list(torch.autograd.grad(out, leaves, dy))


def _module_path(count):
    """The model's path before K7: ``MaskedGroupNorm`` + ``torch.relu``."""
    def fn(x, weight, bias):
        gn = blocks.MaskedGroupNorm(x.shape[1])
        return torch.relu(torch.func.functional_call(
            gn, {"weight": weight, "bias": bias}, (x, count)))
    return fn


WIDTHS = [64, 128, 192, 256, 48, 20]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("count", [1, 2, 19, 37])
@pytest.mark.parametrize("c", WIDTHS)
def test_function_equals_plain_path(c, count, as_tensor):
    x, w, b, dy, cnt = _operands(37, c, count, seed=c + count)
    cnt = cnt if as_tensor else count
    want = _grads(_module_path(cnt), x, w, b, dy)
    got = _grads(lambda xx, ww, bb: gnm._MaskedGnRelu.apply(xx, ww, bb, cnt,
                                                            EPS),
                 x, w, b, dy)
    assert len(got) == len(want) == 4
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and torch.equal(g, e)
    # rows 0 and from the count up are zero, and get no gradient
    assert not got[0][0].any() and not got[0][count:].any()
    assert not got[1][0].any() and not got[1][count:].any()


@pytest.mark.parametrize("c", [64, 20])
def test_modules_keep_their_cpu_path(c):
    """On the CPU ``Gn.relu`` is the plain path, unchanged, and launches
    nothing; with a mask it is the masked GroupNorm + ReLU."""
    x, _, _, _, cnt = _operands(40, c, 29)
    gn = blocks.Gn(c)
    with torch.no_grad():
        gn.gn.weight.copy_(torch.linspace(-1, 2, c))
        gn.gn.bias.copy_(torch.linspace(0.5, -0.5, c))
    before = _cuda.launch_counts()
    assert torch.equal(gn.relu(x, cnt), torch.relu(gn(x, cnt)))
    mask = torch.rand(40, generator=torch.Generator().manual_seed(1)) < 0.6
    assert torch.equal(gn.relu(x, cnt, mask), torch.relu(gn(x, cnt, mask)))
    assert _cuda.launch_counts() == before


@pytest.mark.parametrize("module,keys", [
    (lambda: blocks.GnReluConv(64, 32), ["gn.gn.weight", "gn.gn.bias",
                                         "conv.weight"]),
    (lambda: blocks.GnRelu1x1(64, 32, use_bias=True),
     ["gn.gn.weight", "gn.gn.bias", "conv.weight", "conv.bias"]),
    (lambda: blocks.GnReluCoarsen(64, 128), ["gn.gn.weight", "gn.gn.bias",
                                             "conv.weight"]),
    (lambda: blocks.GnReluFinefy(256, 128), ["gn.gn.weight", "gn.gn.bias",
                                             "conv.weight"]),
    (lambda: blocks.ResnetBlock(64),
     ["conv1.gn.gn.weight", "conv1.gn.gn.bias", "conv1.conv.weight",
      "conv2.gn.gn.weight", "conv2.gn.gn.bias", "conv2.conv.weight"]),
])
def test_state_dict_keys_unchanged(module, keys):
    """The reference schema's names: GroupNorm affine under ``gn.gn``."""
    assert list(module().state_dict()) == keys


def _exact(x, count, weight, bias):
    """The exact GroupNorm in float64 and the bounds on K7's float32
    statistics: each group's mean within ``dm`` and inverse deviation
    within the relative ``rho``, from (n + 1) 2^-24 sum|t| for each float32
    sum of n terms t, plus the roundings of the divisions, the square root
    and the squares."""
    rows, c = x.shape
    groups = gnm.gn_num_groups(c)
    cpg = c // groups
    valid = gnm.valid_rows(rows, count, x.device)
    n = max(int(valid.sum()), 1)
    big_n = n * cpg
    vf = valid.double()[:, None, None]
    xg = x.double().reshape(rows, groups, cpg)
    s = (xg * vf).sum((0, 2))
    mag = (xg.abs() * vf).sum((0, 2))
    mean = s / big_n
    s2 = (((xg - mean[:, None]) ** 2) * vf).sum((0, 2))
    var = s2 / big_n
    inv = 1.0 / torch.sqrt(var + EPS)
    dm = (big_n + 2) * U * mag / big_n
    ds2 = (big_n + 3) * U * (s2 + big_n * dm ** 2) + big_n * dm ** 2
    rv = (ds2 / big_n + 2 * U * var) / (var + EPS)
    rho = 0.5 * rv * (1 + rv) + 3 * U

    def per_channel(t):
        return t.repeat_interleave(cpg)[None, :]

    m_c, inv_c, dm_c, rho_c = map(per_channel, (mean, inv, dm, rho))
    xh = (x.double() - m_c) * inv_c
    dxh = inv_c * (1 + rho_c) * dm_c * (1 + 3 * U) + xh.abs() * (rho_c
                                                                 + 3 * U)
    w, b = weight.double(), bias.double()
    y = xh * w + b
    tol_y = (w.abs() * dxh * (1 + 3 * U)
             + 3 * U * ((w * xh).abs() + b.abs()))
    return dict(valid=valid, groups=groups, cpg=cpg, n=n, big_n=big_n, s=s,
                mag=mag, mean=mean, inv=inv, dm=dm, rho=rho, xh=xh, dxh=dxh,
                y=y, tol_y=tol_y, inv_c=inv_c, rho_c=rho_c)


def _exact_grads(e, dy, weight):
    """The exact gradients (dx, dw, db) in float64 for a ``dy`` that is zero
    wherever K7's y could fall on the other side of zero, and their bounds
    for K7's float32 sums."""
    valid, big_n, n, cpg = e["valid"], e["big_n"], e["n"], e["cpg"]
    rows, c = dy.shape
    w = weight.double()
    gy = dy.double() * (e["y"] > 0) * valid[:, None]
    xh, dxh, inv, rho = e["xh"], e["dxh"], e["inv_c"], e["rho_c"]
    db = gy.sum(0)
    tol_db = (n + 1) * U * gy.abs().sum(0)
    dw = (gy * xh).sum(0)
    tol_dw = ((gy.abs() * dxh).sum(0) * (1 + U)
              + (n + 2) * U * (gy.abs() * (xh.abs() + dxh)).sum(0))
    gg = gy * w

    def group(t):
        return t.reshape(rows, -1, cpg).sum((0, 2)).repeat_interleave(
            cpg)[None, :]

    m1 = group(gg) / big_n
    dm1 = (big_n + 2) * U * group(gg.abs()) / big_n + U * m1.abs()
    m2 = group(gg * xh) / big_n
    ds2 = (group(gg.abs() * dxh)
           + (big_n + 3) * U * group(gg.abs() * (xh.abs() + dxh)))
    dm2 = ds2 / big_n + U * (m2.abs() + ds2 / big_n)
    inner = gg - m1 - xh * m2
    dinner = (U * gg.abs() + dm1 + dxh * (m2.abs() + dm2) + xh.abs() * dm2
              + 3 * U * (gg.abs() + m1.abs() + dm1
                         + (xh.abs() + dxh) * (m2.abs() + dm2)))
    dx = inv * inner * valid[:, None]
    tol_dx = inv * ((1 + rho) * dinner + (rho + 2 * U) * inner.abs())
    return (dx, dw, db), (tol_dx, tol_dw, tol_db)


@pytest.mark.parametrize("c,count", [(64, 300), (48, 2), (20, 411)])
def test_exact_reference_is_autograds_gradient(c, count):
    """The float64 reference the card tests hold K7 to (the formula K7's
    backward computes) equals autograd's gradient of the plain path in
    float64."""
    x, w, b, dy, cnt = _operands(411, c, count, seed=3)
    e = _exact(x, count, w, b)
    (dx, dw, db), _ = _exact_grads(e, dy, w)
    x64, w64, b64 = x.double(), w.double(), b.double()
    out, gx, gw, gb = _grads(
        lambda xx, ww, bb: gnm.masked_gn_relu_plain(xx, cnt, ww, bb, EPS),
        x64, w64, b64, dy.double())
    torch.testing.assert_close(out, torch.relu(e["y"]) * e["valid"][:, None],
                               rtol=1e-12, atol=1e-12)
    for got, want in ((gx, dx), (gw, dw), (gb, db)):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-10)


# ---------------------------------------------------------------------------
# K7 on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 has no CPU mode)")
    return torch.device("cuda")


# (rows, C, count): the main path's at the level capacities 49,152 /
# 24,576 / 12,288 with occupied prefixes below them; then narrow widths,
# one off the multiples of 4 (one-float loads), and counts of 1, 2 and the
# capacity
CARD_SHAPES = [
    (49152, 64, 40417), (49152, 128, 40417), (49152, 192, 40417),
    (24576, 128, 20311), (12288, 256, 7001),
    (3001, 20, 2999), (1024, 48, 2), (777, 30, 777), (500, 64, 1),
]


@pytest.mark.cuda
def test_k7_forward_on_card(cuda_device):
    dev = cuda_device
    before = _cuda.launch_counts()["masked_gn_relu"]
    calls = 0
    for i, (rows, c, count) in enumerate(CARD_SHAPES):
        x, w, b, _, cnt = _operands(rows, c, count, seed=i, device=dev)
        out, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
        calls += 1
        e = _exact(x, count, w, b)
        valid = e["valid"]
        # the group sums (n + 1) 2^-24 sum|x|, and the one rounding of the
        # division by n cpg
        sums = stats[0].double() * e["big_n"]
        assert bool(((sums - e["s"]).abs()
                     <= (e["big_n"] + 2) * U * e["mag"]).all()), (rows, c)
        assert bool(((stats[1].double() / e["inv"] - 1).abs()
                     <= e["rho"]).all()), (rows, c)
        want = torch.relu(e["y"])
        err = (out.double() - want).abs()
        assert bool((err[valid] <= e["tol_y"].expand_as(err)[valid]).all()), \
            (rows, c, float(err[valid].max()))
        assert not out[~valid].any()
        plain = gnm.masked_gn_relu_plain(x, cnt, w, b, EPS)
        assert bool(((out.double() - plain.double()).abs()
                     <= 2 * e["tol_y"]).all()), (rows, c)
        # bit-equal from call to call, and with an int count
        again, stats2 = gnm.masked_gn_relu_forward(x, count, w, b, EPS)
        calls += 1
        assert torch.equal(out, again) and torch.equal(stats, stats2)
    assert _cuda.launch_counts()["masked_gn_relu"] == before + calls


@pytest.mark.cuda
def test_k7_forward_exact_sums_on_card(cuda_device):
    """Whole numbers whose group sums are exact in any order (each group's
    valid rows sum to zero): K7's forward equals the plain version's
    arithmetic on the CPU bit for bit, and its db the exact sums."""
    dev = cuda_device
    for i, (rows, c, count) in enumerate(CARD_SHAPES[:5]):
        x, w, b, dy, cnt = _operands(rows, c, count, seed=10 + i,
                                     device=dev, integer=True)
        out, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
        want = gnm.masked_gn_relu_plain(x.cpu(), count, w.cpu(), b.cpu(),
                                        EPS)
        assert torch.equal(out.cpu(), want), (rows, c)
        assert not stats[0].any()
        _, _, db = gnm.masked_gn_relu_backward(dy, x, stats, cnt, w, b, EPS)
        _, _, db_want = gnm.masked_gn_relu_backward_plain(
            dy.cpu(), x.cpu(), count, w.cpu(), b.cpu(), EPS)
        assert torch.equal(db.cpu(), db_want), (rows, c)


def _quiet_dy(e, dy):
    """``dy`` zeroed where the exact y lies within twice K7's bound of
    zero: there the ReLU's derivative may go either way."""
    return torch.where(e["y"].abs() > 2 * e["tol_y"], dy,
                       torch.zeros((), device=dy.device))


@pytest.mark.cuda
def test_k7_backward_on_card(cuda_device):
    dev = cuda_device
    before = _cuda.launch_counts()["masked_gn_relu_backward"]
    calls = 0
    for i, (rows, c, count) in enumerate(CARD_SHAPES):
        x, w, b, dy, cnt = _operands(rows, c, count, seed=20 + i, device=dev)
        e = _exact(x, count, w, b)
        dy = _quiet_dy(e, dy)
        _, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
        got = gnm.masked_gn_relu_backward(dy, x, stats, cnt, w, b, EPS)
        calls += 1
        want, tols = _exact_grads(e, dy, w)
        plain = gnm.masked_gn_relu_backward_plain(dy, x, cnt, w, b, EPS)
        for name, g, wa, tol, p in zip(("dx", "dw", "db"), got, want, tols,
                                       plain):
            err = (g.double() - wa).abs()
            assert bool((err <= tol).all()), (rows, c, name, float(err.max()))
            assert bool(((g.double() - p.double()).abs() <= 2 * tol).all()), \
                (rows, c, name)
        assert not got[0][~e["valid"]].any()
        again = gnm.masked_gn_relu_backward(dy, x, stats, count, w, b, EPS)
        calls += 1
        for g, a in zip(got, again):
            assert torch.equal(g, a)
    assert _cuda.launch_counts()["masked_gn_relu_backward"] == before + calls


@pytest.mark.cuda
def test_k7_misaligned_rows_on_card(cuda_device):
    """Rows that do not start on 16 bytes take one-float loads, with the
    same results."""
    dev = cuda_device
    x, w, b, dy, cnt = _operands(24576, 128, 20311, seed=5, device=dev)
    flat = torch.empty(x.numel() + 1, device=dev)
    xm = flat[1:].view_as(x)
    xm.copy_(x)
    out, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
    out_m, stats_m = gnm.masked_gn_relu_forward(xm, cnt, w, b, EPS)
    e = _exact(x, 20311, w, b)
    for o in (out, out_m):
        err = (o.double() - torch.relu(e["y"])).abs()
        assert bool((err[e["valid"]]
                     <= e["tol_y"].expand_as(err)[e["valid"]]).all())
    dy = _quiet_dy(e, dy)
    want, tols = _exact_grads(e, dy, w)
    for got in (gnm.masked_gn_relu_backward(dy, x, stats, cnt, w, b, EPS),
                gnm.masked_gn_relu_backward(dy, xm, stats_m, cnt, w, b,
                                            EPS)):
        for g, wa, tol in zip(got, want, tols):
            assert bool(((g.double() - wa).abs() <= tol).all())


@pytest.mark.cuda
def test_k7_function_on_card(cuda_device):
    """``masked_gn_relu`` on the card is the Function: its gradients are
    K7's backward of K7's forward."""
    dev = cuda_device
    x, w, b, dy, cnt = _operands(12288, 256, 7001, seed=6, device=dev)
    got = _grads(lambda xx, ww, bb: gnm.masked_gn_relu(xx, cnt, ww, bb),
                 x, w, b, dy)
    out, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
    want = [out] + list(gnm.masked_gn_relu_backward(dy, x, stats, cnt, w, b,
                                                    EPS))
    for g, wa in zip(got, want):
        assert torch.equal(g, wa)


@pytest.mark.cuda
def test_k7_graph_replay_equals_eager(cuda_device):
    dev = cuda_device
    x, w, b, dy, cnt = _operands(24576, 128, 20311, seed=7, device=dev)

    def both():
        out, stats = gnm.masked_gn_relu_forward(x, cnt, w, b, EPS)
        return (out, stats) + tuple(gnm.masked_gn_relu_backward(
            dy, x, stats, cnt, w, b, EPS))

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
    for c, e in zip(captured, eager):
        assert torch.equal(c, e)
    # the count is read on the device at each replay
    cnt.fill_(1000)
    graph.replay()
    torch.cuda.synchronize()
    for c, e in zip(captured, both()):
        assert torch.equal(c, e)
    assert not captured[0][1000:].any() and not captured[2][1000:].any()


@pytest.mark.cuda
def test_k7_makes_no_host_sync(cuda_device):
    dev = cuda_device
    x, w, b, dy, cnt = _operands(49152, 64, 40417, seed=8, device=dev)
    w.requires_grad_()
    b.requires_grad_()
    xr = x.clone().requires_grad_()
    gnm.masked_gn_relu(xr, cnt, w, b).backward(dy)      # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gnm.masked_gn_relu(xr, cnt, w, b)
        out.backward(dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
