"""The port's training loop against the JAX package's over whole runs, on
the CPU: the moving-class comparison's temporal variant at the smoke scale.

    python scripts/torch_jax_long_run.py --out-dir <dir> \\
        [--runs port:float32,jax:float32,port:bfloat16,jax:bfloat16] \\
        [--epochs 4] [--threads 2] [--report-only]

Writes the moving worlds with ``experiments.train_lidar.write_worlds`` (the
smoke scale: 16 beams x 256 azimuths, 4,096 points a scan; 2 train worlds
x 6 scans and the held-out world), checks with ``occupancy_worlds`` that
the raised capacities (``CAPS``) hold every window's union, and formats the
temporal cfg as ``train_lidar.format_cfg`` does (``compute_dtype`` added to
``runtime`` for float32).  Each run then trains from the same weights: the
JAX model's seed-0 initialisation, written as a reference-schema ``.pt``
for the port and carried into a ``.ckpt`` for the JAX loop (its loop cannot
load a ``.pt``), as ``tests/test_torch_loop.py`` does.  Both loops draw the
same shuffle (seed 0) over the same on-disk windows.

Every run is its own process (the runs go side by side) and writes
``<dir>/run_<side>_<dtype>_t<threads>.json``: each training step's loss,
and each epoch's valid mIoU and per-class IoUs.  A run ``side:dtype``
takes ``--threads`` torch intra-op threads, ``side:dtype:N`` takes N (the
JAX runs keep XLA's Eigen thread pool off, so each stays on its share of
the cores).  The report (``<dir>/report.json``, printed) gives, for each
pair, every step's two losses, the first step at which they part by more
than 1e-4, 1e-3 and 1e-2 (and the largest and median difference), and
each epoch's valid mIoU and moving mean on both sides.  The
pairs: the port against JAX in each dtype; each side's bf16 against its
float32, the control for how far bf16 alone moves a trajectory; and a run
on another thread count against the same run on ``--threads``, the
control for how far float32 sums in another order move it
(``port:float32:1``: CPU matrix products and scatter-adds block and
accumulate differently on one thread).

``--report-only`` compares the JSONs already in ``--out-dir``.  The JAX
package is imported only in the JAX runs' processes; nothing of the port
imports this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCALE = "smoke"
WORLDS, SCANS = 2, 6
# capacity_level0, min_capacity: every level above occupancy_worlds' worst
# count at this scale (the smoke scale's own 4,096 / 1,024 saturate)
CAPS = (16384, 4096)
THRESHOLDS = (1e-4, 1e-3, 1e-2)
MOVING_IDS = ("20", "22")       # moving-car, moving-person
RUNS = "port:float32,jax:float32,port:bfloat16,jax:bfloat16"


def cfg_text(side: str, dtype: str, root: str, epochs: int) -> str:
    """The temporal variant's cfg, as ``train_lidar`` formats it, loading
    the shared initial weights; capacities raised to ``CAPS``."""
    from temporal_latticenet_tpu_torch.experiments import train_lidar

    run_dir = os.path.join(root, f"{side}_{dtype}")
    text = train_lidar.format_cfg(
        "temporal", epochs=epochs, scale=SCALE, scope=1, aug=0, frames=4,
        rnn="", remat="full", ckpt=run_dir, preds=os.path.join(run_dir,
                                                               "preds"),
        data=os.path.join(root, "data"), load_ckpt="true",
        load_model=os.path.join(root, "init.pt" if side == "port"
                                else f"init_{dtype}.ckpt"))
    _, _, _, cap0, min_cap = train_lidar.SCALES[SCALE]
    for a, b in ((f"hash_table_capacity: {cap0}",
                  f"hash_table_capacity: {CAPS[0]}"),
                 (f"capacity_level0: {cap0}", f"capacity_level0: {CAPS[0]}"),
                 (f"min_capacity: {min_cap}", f"min_capacity: {CAPS[1]}")):
        assert a in text, a
        text = text.replace(a, b)
    if dtype == "float32":
        text = text.replace('remat_mode: "full"',
                            'remat_mode: "full"\n    compute_dtype: "float32"')
    return text


def prepare(root: str, epochs: int, dtypes) -> dict:
    """Worlds, capacity check, cfgs and the shared initial weights."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from temporal_latticenet_tpu import config as jconfig
    from temporal_latticenet_tpu.train import checkpoint as jckpt
    from temporal_latticenet_tpu.train import engine as jengine
    from temporal_latticenet_tpu.train import torch_convert as tc
    from temporal_latticenet_tpu_torch.experiments import (occupancy_worlds,
                                                           train_lidar)

    data = os.path.join(root, "data")
    train_lidar.write_worlds(data, WORLDS, SCANS, SCALE, 1)
    # worlds 0..8 are generated from seeds 1000..1008: the train worlds'
    # and the held-out world's (sequence 08)
    occ = occupancy_worlds.main(
        ["--scale", SCALE, "--moving", "1", "--worlds", "9",
         "--scans", str(SCANS), "--stride", "1", "--cpu",
         "--cap0", str(CAPS[0]), "--min-cap", str(CAPS[1])])
    full = [lvl for lvl, (w, c) in enumerate(zip(occ["worst"], occ["caps"]))
            if w >= c]
    if full:
        raise SystemExit(f"levels {full} saturate: worst {occ['worst']} of "
                         f"{occ['caps']}")

    for side in ("port", "jax"):
        for dtype in dtypes:
            os.makedirs(os.path.join(root, f"{side}_{dtype}"), exist_ok=True)
            with open(os.path.join(root, f"cfg_{side}_{dtype}.cfg"), "w") as f:
                f.write(cfg_text(side, dtype, root, epochs))

    # the JAX model's seed-0 weights as one reference-schema .pt, carried
    # into each dtype's .ckpt (parameters are float32 in both)
    pt = os.path.join(root, "init.pt")
    for i, dtype in enumerate(dtypes):
        jp = jconfig.cfgParser(os.path.join(root, f"cfg_jax_{dtype}.cfg"))
        jcfg = jconfig.model_config_from_cfg(jp,
                                             jconfig.nr_classes_from_cfg(jp))
        jrt = jconfig.runtime_config_from_cfg(jp)
        assert jcfg.compute_dtype == dtype, jcfg.compute_dtype
        _, jstate, _ = jengine.create_train_state(jcfg, jrt, 1e-3, 1e-4)
        inner = jax.tree_util.tree_map(np.asarray, jstate.params["params"])
        if i == 0:
            sd = tc.export_state_dict(inner, jcfg)
            torch.save({k: torch.tensor(v) for k, v in sd.items()}, pt)
        params = tc.load_pt_checkpoint(pt, jcfg, inner)
        jckpt.save(os.path.join(root, f"init_{dtype}.ckpt"),
                   {"params": params}, jstate.opt_state, 0)
    return dict(occupancy_worst=occ["worst"], caps=occ["caps"])


def train(root: str, side: str, dtype: str, threads: int) -> dict:
    """One loop over the whole cfg; each step's loss and each epoch's valid
    IoUs."""
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from temporal_latticenet_tpu.train import loop
    else:
        import torch
        torch.set_num_threads(threads)
        from temporal_latticenet_tpu_torch.train import loop
    steps, valid = [], []

    class Recording(loop.StateCallback):
        def after_forward_pass(self, *, phase=None, **kw):
            if phase.grad:
                steps.append(float(kw["loss"]))
            super().after_forward_pass(phase=phase, **kw)

        def epoch_ended(self, *, phase=None, **kw):
            if not phase.grad:
                miou, iou = phase.scores.compute_stats()
                valid.append(dict(epoch=phase.epoch_nr, miou=float(miou),
                                  iou={str(k): float(v)
                                       for k, v in iou.items()}))
            super().epoch_ended(phase=phase, **kw)

    loop.StateCallback = Recording
    cfg = os.path.join(root, f"cfg_{side}_{dtype}.cfg")
    t0 = time.perf_counter()
    if side == "jax":
        loop.run_training(cfg)
    else:
        loop.run_training(cfg, device="cpu")
    return dict(side=side, dtype=dtype, threads=threads, losses=steps,
                valid=valid, seconds=time.perf_counter() - t0)


def first_parting(a, b, threshold):
    """1-based step at which |a - b| first exceeds ``threshold``, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if abs(x - y) > threshold:
            return i + 1
    return None


def moving_mean(e: dict) -> float:
    return sum(e["iou"].get(c, 0.0) for c in MOVING_IDS) / len(MOVING_IDS)


def name(r: dict) -> str:
    return f"{r['side']}:{r['dtype']}:{r['threads']}"


def compare(a: dict, b: dict) -> dict:
    n = min(len(a["losses"]), len(b["losses"]))
    diffs = [abs(x - y) for x, y in zip(a["losses"], b["losses"])]
    return dict(
        pair=f"{name(a)} vs {name(b)}",
        steps=n,
        losses=list(zip(a["losses"], b["losses"])),
        first_step_parting={str(t): first_parting(a["losses"], b["losses"], t)
                            for t in THRESHOLDS},
        max_abs_loss_diff=max(diffs) if diffs else None,
        median_abs_loss_diff=float(np.median(diffs)) if diffs else None,
        epochs=[dict(epoch=ea["epoch"], miou=(ea["miou"], eb["miou"]),
                     moving_mean=(moving_mean(ea), moving_mean(eb)))
                for ea, eb in zip(a["valid"], b["valid"])])


def report(out_dir: str, threads: int) -> dict:
    """The pairs: the port against JAX in each dtype, each side's bf16
    against its float32, and each run on another thread count (the same
    sums in another order) against the same run on ``threads``."""
    runs = {}
    for f in os.listdir(out_dir):
        if f.startswith("run_") and f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fh:
                r = json.load(fh)
            runs[(r["side"], r["dtype"], r["threads"])] = r
    t = threads
    pairs = [(("port", d, t), ("jax", d, t)) for d in ("float32", "bfloat16")]
    pairs += [((s, "bfloat16", t), (s, "float32", t)) for s in ("port", "jax")]
    pairs += [(k, k[:2] + (t,)) for k in sorted(runs) if k[2] != t]
    out = dict(runs={name(r): dict(steps=len(r["losses"]),
                                   seconds=r["seconds"])
                     for r in runs.values()},
               pairs=[compare(runs[a], runs[b]) for a, b in pairs
                      if a in runs and b in runs])
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(out, f, indent=1)
    for p in out["pairs"]:
        print(f"{p['pair']}: {p['steps']} steps, first parting "
              f"{p['first_step_parting']}, max |d loss| "
              f"{p['max_abs_loss_diff']:.3g}, median "
              f"{p['median_abs_loss_diff']:.3g}")
        for i, (x, y) in enumerate(p["losses"]):
            print(f"  step {i + 1}: {x:.7f} / {y:.7f}, |d| {abs(x - y):.2e}")
        for e in p["epochs"]:
            print(f"  epoch {e['epoch']}: valid mIoU {e['miou'][0]:.4f} / "
                  f"{e['miou'][1]:.4f}, moving mean "
                  f"{e['moving_mean'][0]:.4f} / {e['moving_mean'][1]:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--root", default="",
                    help="worlds, cfgs, weights (default: <out-dir>/work)")
    ap.add_argument("--runs", default=RUNS)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = args.root or os.path.join(args.out_dir, "work")
    os.makedirs(args.out_dir, exist_ok=True)

    if args.one:        # a child: one run
        side, dtype, threads = args.one.split(":")
        r = train(root, side, dtype, int(threads))
        with open(os.path.join(args.out_dir,
                               f"run_{side}_{dtype}_t{threads}.json"),
                  "w") as f:
            json.dump(r, f)
        return 0
    if not args.report_only:
        # side:dtype[:threads], threads by default --threads
        runs = [r if r.count(":") == 2 else f"{r}:{args.threads}"
                for r in args.runs.split(",")]
        t0 = time.perf_counter()
        prep = prepare(root, args.epochs, sorted({r.split(":")[1]
                                                  for r in runs}))
        print(f"prepared in {time.perf_counter() - t0:.0f} s: {prep}",
              flush=True)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--out-dir",
             args.out_dir, "--root", root, "--one", r],
            env=dict(os.environ, OMP_NUM_THREADS=r.split(":")[2],
                     XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_"
                                "cpu_multi_thread_eigen=false").strip()),
            stdout=open(os.path.join(args.out_dir, f"log_{r.replace(':', '_')}"
                                     ".txt"), "w"),
            stderr=subprocess.STDOUT) for r in runs]
        codes = [p.wait() for p in procs]
        print(f"runs {dict(zip(runs, codes))} in "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        if any(codes):
            return 1
    report(args.out_dir, args.threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
