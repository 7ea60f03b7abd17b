"""Matrix-product FLOPs of Temporal LatticeNet, counted from the
configuration's widths and the rows each product runs over.

The count follows the model's forward (``reference/models/lnn_seq.py``)
frame by frame: the pointnet MLP over the frame's point rows (4 a valid
point), the early, middle, bottleneck and late fusions (the identity on a
sequence's first frame), every lattice convolution (9 taps), the
bottleneck blocks' 1x1 convolutions, the finefy slices (4 corners a fine
vertex), and on the final frame the up-stage resnets and the deform slice
and classifier over the points.  A non-final frame stops after the last
active fusion site, as the model's early return does.  Each product of an
(m, k) by a (k, n) matrix counts 2 m k n.

The benchmark passes the occupied vertices of the reference's lattice (the
count without the reserved row 0) and the valid points, so the count is
the useful work of these inputs and moves with no change of the port; a
test passes the capacities and the padded rows and matches
``torch.utils.flop_counter.FlopCounterMode`` on the reference.
"""

from __future__ import annotations

SITES = ("early", "middle", "bottleneck", "late")


def _fusion(kind: str, c: int, i: int, rows: float) -> float:
    macs = {"gru": c * c + 3 * c * i + 3 * c * c,
            "lstm": c * c + 4 * c * i + 4 * c * c,
            "linear": c * c + (c + i) * c,
            "cga": 3 * c * c,
            "aflow": 9 * c + (c + i) * c,
            "maxpool": 0, "none": 0}[kind]
    return 2.0 * rows * macs


def frame_flops(m: dict, rows, points: float, first: bool,
                final: bool) -> float:
    """FLOPs of one frame.  ``m``: the configuration's ``model`` section;
    ``rows``: the vertex rows the products run over at each level
    (``nr_downsamples + 1`` of them); ``points``: the point rows of the
    slice (the pointnet runs over 4 rows a point)."""
    L = m["nr_downsamples"]
    kinds = (list(m["rnn_modules"]) if m["sequence_learning"]
             else ["none"] * 4)
    last = max([i for i, k in enumerate(kinds) if k != "none"], default=3)
    cut = last if m["sequence_learning"] and not final else None
    pn = [3 + 1] + list(m["pointnet_layers"])
    c0 = m["pointnet_start_nr_channels"]
    f = 2.0 * 4 * points * sum(a * b for a, b in zip(pn[:-1], pn[1:]))
    early = 2 * pn[-1]

    def fuse(site: int, c: int, i: int, n: float) -> float:
        return 0.0 if first else _fusion(kinds[site], c, i, n)

    f += fuse(0, early, early, rows[0])
    f += 2.0 * rows[0] * 9 * early * c0
    if cut == 0:
        return f
    cur, skips = c0, []
    for i in range(L):
        f += 2.0 * m["nr_blocks_down_stage"][i] * 2 * rows[i] * 9 * cur * cur
        skips.append(cur)
        if i == 0:
            f += fuse(1, c0, cur, rows[0])
            if cut == 1:
                return f
        nxt = int(cur * 2 * m["compression_factor"])
        f += 2.0 * rows[i + 1] * 9 * cur * nxt
        cur = nxt
    mid = cur // 2
    f += (2.0 * m["nr_blocks_bottleneck"] * rows[L]
          * (cur * mid + 9 * mid * mid + mid * cur))
    f += fuse(2, 4 * c0, cur, rows[L])
    if cut == 2:
        return f
    for i in range(L):
        lvl = L - 1 - i
        nf = cur // 2
        f += 2.0 * rows[lvl + 1] * 9 * cur * nf     # finefy's convolution
        f += 2.0 * rows[lvl] * 4 * nf               # its slice to the fine level
        cur = nf + skips[lvl]
        if i == L - 1:
            f += fuse(3, 3 * c0, cur, rows[0])
            if cut == 3:
                return f
    f += 2.0 * m["nr_blocks_up_stage"][L - 1] * 2 * rows[0] * 9 * cur * cur
    # deform slice: the delta weights, the blend, the classifier
    f += 2.0 * points * ((4 * cur + 4) * 4 + 4 * cur + cur * m["nr_classes"])
    return f


def sequence_flops(m: dict, rows, points) -> float:
    """FLOPs of one sequence's forward: ``rows`` (T, L + 1) and ``points``
    (T,), the last frame final."""
    t = len(points)
    return sum(frame_flops(m, rows[f], points[f], f == 0, f == t - 1)
               for f in range(t))
