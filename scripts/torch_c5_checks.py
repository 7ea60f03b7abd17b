"""The moving-class comparison's temporal runs over seeds, and the card
against the CPU on the experiments' own data, on one card.

    python scripts/torch_c5_checks.py --out-dir <dir> \\
        [--runs 1,2,3,f32:0] [--check 1] [--windows 2] [--threads 2] \\
        -- <train_lidar flags: --moving 1 --scale full --worlds 10
            --scans 10 --epochs 16 --scope 1>

Writes the worlds once under ``build/c5/data``, then starts one
``scripts/torch_lidar_experiments.py`` process for each entry of
``--runs``, all side by side on the card: ``N`` is the temporal variant
with ``--seed N``, ``f32:N`` the same in float32 (``--float32``), and a
``static:N`` or ``accum:N`` entry that variant.  Each run has its root
``build/c5/<entry>`` (the worlds linked in) and writes its results and
measurements (each epoch's valid mIoU and IoUs) under
``<dir>/<entry>``.  The runs share the card and the host's cores, so their
seconds a step are not those of a run alone; their IoUs are (a run is
deterministic on the card).

Then ``--check <entry>`` takes that run's final checkpoint and
``--windows`` training windows (spread over the train split) and holds
the card against the CPU, which runs the kernels' plain versions, on the
default (K4) route:

* ``grad_step``: the loss within 1e-2, every parameter's gradient at a
  cosine of at least 0.99, the global norm within 2 % (``chip_smoke.py``
  phase 9's tolerances);
* ``run_eval`` on the held-out world: the valid mIoU and the confusion
  counts on both, the points whose label differs, and the top-two gap of
  the log-probabilities there on each side;
* ``run_eval`` again with ``compute_dtype: "float32"`` in a copy of the
  cfg: the control that says how many of the bf16 evaluation's differing
  labels bf16's roundings alone account for.

Everything goes to ``<dir>/c5_checks.json``; the card's name and power
limit are in it.  ``--runs ""`` makes the check alone, on a root that is
already there.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from temporal_latticenet_tpu_torch.experiments import train_lidar  # noqa: E402
from temporal_latticenet_tpu_torch.ops import _cuda  # noqa: E402

WORK = os.path.join(ROOT, "build", "c5")
TIE = 1e-4      # a top-two gap this small may flip between devices


def split_entry(entry: str):
    """``N`` / ``f32:N`` / ``<variant>:N`` -> (variant, seed, float32)."""
    kind, _, seed = entry.rpartition(":")
    if kind in ("", "f32"):
        return "temporal", int(seed), kind == "f32"
    return kind, int(seed), False


def start_runs(entries, out_dir, data, flags, threads):
    procs = []
    for entry in entries:
        variant, seed, f32 = split_entry(entry)
        tag = entry.replace(":", "_")
        cmd = [sys.executable, os.path.join(ROOT, "scripts",
                                            "torch_lidar_experiments.py"),
               "--out-dir", os.path.join(out_dir, tag), "--variants", variant,
               "--root", os.path.join(WORK, tag), "--data", data]
        cmd += ["--float32"] if f32 else []
        cmd += ["--"] + flags + ["--seed", str(seed)]
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
        log = open(os.path.join(out_dir, tag, "log.txt"), "w")
        procs.append((entry, subprocess.Popen(
            cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def _model(cfg_path, checkpoint, device):
    from temporal_latticenet_tpu_torch.config import (
        cfgParser, model_config_from_cfg, nr_classes_from_cfg,
        runtime_config_from_cfg)
    from temporal_latticenet_tpu_torch.train import checkpoint as ckpt
    from temporal_latticenet_tpu_torch.train import engine

    parser = cfgParser(cfg_path)
    cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
    rt = runtime_config_from_cfg(parser)
    model, _ = engine.create_train_state(cfg, rt, 1e-3, 1e-4, device=device)
    ckpt.load(checkpoint, model, cfg=cfg)
    step, _ = engine.make_train_step(model, cfg, rt, ignore_index=0)
    return parser, cfg, rt, step


def grads_card_vs_cpu(cfg_path, checkpoint, windows: int) -> dict:
    """``grad_step`` on the card and on the CPU at ``windows`` train
    windows, from the same checkpoint, on the default (K4) route."""
    from temporal_latticenet_tpu_torch.train import engine, loop

    if os.environ.get("TLN_MAXSCAN_PACKED", "0") == "1":
        raise SystemExit("the check runs the default route: unset "
                         "TLN_MAXSCAN_PACKED")
    parser, cfg, rt, dev_step = _model(cfg_path, checkpoint, "cuda")
    _, _, _, cpu_step = _model(cfg_path, checkpoint, "cpu")
    ds = loop.make_datasets(parser, cfg, rt, splits=("train",))["train"]
    picks = np.linspace(0, len(ds) - 1, windows).round().astype(int)
    out = []
    for i in picks:
        frames = ds[int(i)]
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        loss_d, g_d = dev_step.grad_step(engine.SeqBatch.stack([frames],
                                                               "cuda"))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = _cuda.launch_counts()
        t0 = time.perf_counter()
        loss_c, g_c = cpu_step.grad_step(engine.SeqBatch.stack([frames],
                                                               "cpu"))
        t_cpu = time.perf_counter() - t0
        r = chip_smoke.grad_agreement(loss_c, g_c, loss_d, g_d)
        r.update(window=int(i), points=int(frames[-1].mask.sum()),
                 norm_ratio=r["grad_norm_card"] / r["grad_norm_cpu"],
                 launches_card=launches, seconds_card=t_card,
                 seconds_cpu=t_cpu)
        print(f"[grads] window {i}: loss {r['loss_card']:.6f} card / "
              f"{r['loss_cpu']:.6f} CPU, smallest cosine "
              f"{r['min_grad_cosine']:.6f} ({r['min_cosine_param']}), norm "
              f"ratio {r['norm_ratio']:.6f}, K4 "
              f"{launches['sorted_segment_max_u32']} K5 "
              f"{launches['sorted_segment_max_window']}", flush=True)
        out.append(r)
    return dict(windows=out, tolerance=dict(
        loss=chip_smoke.LOSS_ATOL, cosine=chip_smoke.GRAD_COSINE,
        norm_rtol=chip_smoke.NORM_RTOL))


def eval_card_vs_cpu(cfg_path, checkpoint) -> dict:
    """``run_eval`` of the valid split on the card and on the CPU: mIoU,
    confusion counts, and where the labels differ, the top-two gaps."""
    from temporal_latticenet_tpu_torch.config import (
        cfgParser, model_config_from_cfg, nr_classes_from_cfg,
        runtime_config_from_cfg)
    from temporal_latticenet_tpu_torch.train import loop

    parser = cfgParser(cfg_path)
    cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
    ds = loop.make_datasets(parser, cfg, runtime_config_from_cfg(parser),
                            splits=("valid",))["valid"]
    masks = [ds[i][-1].mask for i in range(len(ds))]
    predict = loop._predict
    side = {}
    for device in ("cuda", "cpu"):
        preds, gaps = [], []

        def recording(logp):
            top2 = torch.topk(logp.float(), 2, dim=-1).values
            gaps.append((top2[..., 0] - top2[..., 1])[0].cpu().numpy())
            p = predict(logp)
            preds.append(p[0])
            return p

        loop._predict = recording
        t0 = time.perf_counter()
        try:
            miou, phase = loop.run_eval(cfg_path, split="valid",
                                        checkpoint_path=checkpoint,
                                        device=device)
        finally:
            loop._predict = predict
        sc = phase.scores
        side[device] = dict(
            miou=float(miou), seconds=time.perf_counter() - t0,
            intersection=sc.intersection_per_class.tolist(),
            union=sc.union_per_class.tolist(),
            iou={str(k): float(v) for k, v in sc.iou_per_class().items()},
            preds=preds, gaps=gaps)
    d, c = side["cuda"], side["cpu"]
    differ, ties, gap_max = 0, 0, 0.0
    for m, pd, pc, gd, gc in zip(masks, d["preds"], c["preds"], d["gaps"],
                                 c["gaps"]):
        diff = (pd != pc) & m
        differ += int(diff.sum())
        if diff.any():
            g = np.minimum(gd[diff], gc[diff])
            ties += int((g <= TIE).sum())
            gap_max = max(gap_max, float(g.max()))
    scored = int(sum(m.sum() for m in masks))
    for s in (d, c):
        del s["preds"], s["gaps"]
    out = dict(card=d, cpu=c, windows=len(masks), points_scored=scored,
               points_differing=differ, differing_within_tie=ties,
               differing_gap_max=gap_max, tie=TIE,
               confusion_equal=(d["intersection"] == c["intersection"]
                                and d["union"] == c["union"]),
               miou_abs_diff=abs(d["miou"] - c["miou"]))
    print(f"[eval] valid mIoU {d['miou']:.6f} card / {c['miou']:.6f} CPU; "
          f"{differ} of {scored} labels differ ({ties} within a top-two "
          f"gap of {TIE}, largest gap {gap_max:.4g}); confusion equal "
          f"{out['confusion_equal']}", flush=True)
    return out


def float32_cfg(cfg_path: str) -> str:
    """A copy of ``cfg_path`` beside it with ``compute_dtype: "float32"``
    in its ``runtime`` section."""
    with open(cfg_path) as f:
        text = f.read()
    if "compute_dtype" in text:
        raise ValueError(f"{cfg_path} already sets compute_dtype")
    text = text.replace("    remat_mode:", '    compute_dtype: "float32"\n'
                        "    remat_mode:", 1)
    out = cfg_path[:-len(".cfg")] + "_float32.cfg"
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = []
    if "--" in argv:
        i = argv.index("--")
        argv, flags = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--runs", default="1,2,3")
    ap.add_argument("--check", default="")
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_c5_checks: needs CUDA", file=sys.stderr)
        return 2
    tl = train_lidar.parse_args(flags)
    os.makedirs(args.out_dir, exist_ok=True)
    dline = chip_smoke.device_line()
    print(dline, flush=True)
    report = dict(device=dline, flags=flags, runs={})
    data = os.path.join(WORK, "data")
    t0 = time.perf_counter()
    entries = [e for e in args.runs.split(",") if e]
    if entries:
        train_lidar.write_worlds(data, tl.worlds, tl.scans, tl.scale,
                                 tl.moving)
        # the kernels built once, before the runs start side by side
        print(json.dumps(_cuda.build()), flush=True)
        for entry, p in start_runs(entries, args.out_dir, data, flags,
                                   args.threads):
            report["runs"][entry] = dict(exit=p.wait(),
                                         seconds=time.perf_counter() - t0)
            print(f"[runs] {entry}: exit {report['runs'][entry]['exit']} "
                  f"after {report['runs'][entry]['seconds']:.0f} s",
                  flush=True)
        write(report, args.out_dir, t0)
    failed = any(r["exit"] for r in report["runs"].values())
    if args.check:
        _cuda.build()
        variant, _, _ = split_entry(args.check)
        root = os.path.join(WORK, args.check.replace(":", "_"))
        cfg_path = os.path.join(root, f"cfg_{variant}.cfg")
        ckpt_dir = os.path.join(root, f"ckpt_{variant}")
        _, name = train_lidar.newest_epoch_checkpoint(ckpt_dir)
        checkpoint = os.path.join(ckpt_dir, name)
        report["check"] = dict(entry=args.check, checkpoint=name)
        report["check"]["grads"] = grads_card_vs_cpu(cfg_path, checkpoint,
                                                     args.windows)
        write(report, args.out_dir, t0)
        report["check"]["eval"] = eval_card_vs_cpu(cfg_path, checkpoint)
        write(report, args.out_dir, t0)
        report["check"]["eval_float32"] = eval_card_vs_cpu(
            float32_cfg(cfg_path), checkpoint)
        failed |= not all(w["within_tolerance"]
                          for w in report["check"]["grads"]["windows"])
    write(report, args.out_dir, t0)
    return 1 if failed else 0


def write(report, out_dir, t0):
    """``<out_dir>/c5_checks.json``, written again as each part ends."""
    report["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "c5_checks.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
