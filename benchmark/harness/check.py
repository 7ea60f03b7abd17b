"""The numbers that decide ``correct``: the port's answers against the
benchmark's float32 reference (``benchmark/reference``), each number held
to its limit from ``benchmark/limits/<workload>.json``.

Served answers (a sequence's or a final frame's log-probabilities and the
labels fetched to the host), over the valid points:

* ``logp_gap``: the largest |port - reference| of a log-probability;
* ``logp_rms``: the root mean square of those differences;
* ``label_gap``: the largest gap by which the reference's log-probability
  of the port's label lies below the reference's best;
* ``label_flip_pct``: the share of points whose label is not the
  reference's best;
* ``confident_flip_pct``: the share of points whose reference label leads
  the runner-up by ``CONFIDENT`` or more (a factor e in probability) and
  whose served label is another.  The benchmark compares this one: the
  others are dominated by near-ties, where bf16 and float8 alike flip
  labels (see PERF.md), and do not separate the two.

Training (three steps, the first three of the run's trainer): the served
numbers of the first step's log-probabilities (its forward), and these,
the norms taken by the worst leaf, measured against the reference's norm
of that leaf or of the median leaf, whichever is larger:

* ``loss1_gap``: |port - reference| / |reference| of the first step's
  loss (the forward alone: the later steps start from weights that
  AdamW's first, nearly sign-like update has already parted);
  ``loss_gap``: the largest over the steps;
* ``grad_gap``: the first gradient's norms, the port's worked out from its
  optimizer's state after one step (``grad_gap_median``: the median
  leaf's gap instead of the worst);
* ``update_gap``: the norms of the parameters' change after three steps,
  without the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone);
* ``grad_diff_median``: the norm of the difference between the port's
  first gradient and the reference's, by the median leaf;
* ``grad_cos_median``: 1 - the cosine between the port's first gradient
  and the reference's, by the median leaf of those that the update counts
  (1 where the port's is zero).  The gaps of norms cannot see a backward
  that turns a gradient's direction where AdamW's first update, nearly
  sign-like, hides it; this one can, and rounding moves it only to second
  order.
"""

from __future__ import annotations

import json
import os

import torch

CONFIDENT = 1.0   # nats between the reference's best label and the next


def served(prog_logp, prog_labels, ref_logp, mask) -> dict:
    m = mask.to(ref_logp.device)
    d = (prog_logp.to(ref_logp.device).float() - ref_logp)[m]
    top2 = ref_logp.topk(2, dim=-1)
    margin = (top2.values[:, 0] - top2.values[:, 1])[m]
    lab = prog_labels.to(ref_logp.device).long()
    mine = ref_logp.gather(1, lab[:, None])[:, 0]
    flip = (lab != top2.indices[:, 0])[m]
    return {"logp_gap": float(d.abs().max()),
            "logp_rms": float(d.double().pow(2).mean().sqrt()),
            "label_gap": float((top2.values[:, 0] - mine)[m].max()),
            "label_flip_pct": float(100.0 * flip.double().mean()),
            "confident_flip_pct": float(
                100.0 * (flip & (margin >= CONFIDENT)).double().mean())}


def merge(readings) -> dict:
    """The worst of each number over several comparisons."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    pn, rn = _norms({k: prog[k] for k in names}), _norms({k: ref[k] for k in names})
    med = float(torch.tensor(sorted(rn.values())).median())
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in names]


def leaf_diffs(prog: dict, ref: dict, names) -> list:
    rn = _norms({k: ref[k] for k in names})
    med = float(torch.tensor(sorted(rn.values())).median())
    return [float((prog[k].double() - ref[k].double()).norm())
            / max(rn[k], med) for k in names]


def leaf_cosines(prog: dict, ref: dict, names) -> list:
    """1 - cos(port, reference) of each leaf; 1 where either is zero."""
    out = []
    for k in names:
        a, b = prog[k].double().flatten(), ref[k].double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        out.append(1.0 - (float(a @ b) / (na * nb) if na > 0 and nb > 0
                          else 0.0))
    return out


def training(prog_losses, ref_losses, prog_g1, ref_g1, prog_delta,
             ref_delta, prog_logp1, ref_logp1, mask) -> dict:
    names = sorted(ref_g1)
    gn = _norms(ref_g1)
    med = float(torch.tensor(sorted(gn.values())).median())
    moved = [k for k in names if gn[k] >= 1e-3 * med]
    rel = [abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)]
    grads = leaf_gaps(prog_g1, ref_g1, names)
    diffs = leaf_diffs(prog_g1, ref_g1, names)
    cosines = leaf_cosines(prog_g1, ref_g1, moved)
    return {"loss1_gap": rel[0], "loss_gap": max(rel),
            "grad_gap": max(grads),
            "grad_gap_median": float(torch.tensor(grads).median()),
            "grad_diff_median": float(torch.tensor(diffs).median()),
            "grad_cos_median": float(torch.tensor(cosines).median()),
            "update_gap": max(leaf_gaps(prog_delta, ref_delta, moved)),
            **served(prog_logp1, prog_logp1.argmax(dim=-1), ref_logp1, mask)}


def limits(bench_dir: str, workload: str) -> dict:
    with open(os.path.join(bench_dir, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def verdict(numbers: dict, lims: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: every one at or under it (a NaN fails)."""
    out, ok = {}, True
    for k, lim in lims.items():
        v = numbers[k]
        out[k] = {"value": v, "limit": lim}
        if not (v <= lim):
            ok = False
    return ok, out
