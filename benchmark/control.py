"""The readings that the limits of ``benchmark/limits/`` are set from: for
each seed, the port's numbers against the float32 reference (the cell's
loop: set-up, a short window at the cell's load, its check) and the
precision control's (the reference computed with float8 operands,
``compute_dtype="float8_e4m3fn"``, put in the port's place), in one
process:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 2]
        [--program-only]
        [--fault <a fault of harness/faults.py>]

Prints one JSON line per seed (with a fault planted, the program's
readings alone) and writes them to ``--out`` if given.  The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from harness import check, faults  # noqa: E402
from harness.core import Context, level_rows, load_file  # noqa: E402


def control_served(ctx, keys):
    """The float8 reference's numbers against the float32 reference."""
    from reference import engine as ref
    f32, cfg32 = ctx.ref_model()
    f8, cfg8 = ctx.ref_model("float8_e4m3fn")
    out = []
    with torch.no_grad():
        for k in keys:
            r, _, _ = ref.forward(f32, cfg32, ctx.ref_rt, ctx.pos[k],
                                  ctx.val[k], ctx.mask[k])
            c, _, _ = ref.forward(f8, cfg8, ctx.ref_rt, ctx.pos[k],
                                  ctx.val[k], ctx.mask[k])
            out.append(check.served(c, c.argmax(dim=-1), r,
                                    ctx.mask[k, -1]))
    return check.merge(out)


def control_training(ctx, steps):
    from reference import engine as ref
    tr = ctx.config["train"]
    windows = [(ctx.pos[k], ctx.val[k], ctx.lab[k], ctx.mask[k])
               for k in ctx.order[:steps]]
    runs = []
    for cd in ("float32", "float8_e4m3fn"):
        model, cfg = ctx.ref_model(cd)
        runs.append(ref.train_steps(model, cfg, ctx.ref_rt, windows,
                                    tr["lr"], tr["weight_decay"],
                                    tr["ignore_index"]))
        del model
    (l32, g32, t32, p32), (l8, g8, t8, p8) = runs
    w0 = ctx.weights
    return check.training(l8, l32, g8, g32,
                          {n: t8[n] - w0[n] for n in t8},
                          {n: t32[n] - w0[n] for n in t32},
                          p8, p32, ctx.mask[ctx.order[0], -1])


def reading(bench_dir, spec, workload, config, traffic, seed, seconds,
            device, with_control=True):
    ctx = Context(bench_dir, workload, config, traffic, seed, device)
    ctx.make_inputs()
    ctx.make_weights()
    loop = load_file(os.path.join(bench_dir, "loops",
                                  f"{traffic['loop']}.py"),
                     "loop_" + traffic["loop"]).Loop(ctx)
    loop.setup()
    if traffic["loop"] != "train":
        loop.window(seconds)
    keys = ctx.sample(getattr(loop, "held", {}), 3)
    loop.release()
    occupancy = [max(c[l] for c in counts[0]) for counts in
                 level_rows(ctx).values() for l in range(len(ctx.caps))]
    prog, _ = loop.check()
    if not with_control:
        ctrl = None
    elif traffic["loop"] == "train":
        ctrl = control_training(ctx, traffic["check_steps"])
    else:
        ctrl = control_served(ctx, keys)
    levels = len(ctx.caps)
    return {"workload": workload, "seed": seed, "program": prog,
            "control": ctrl,
            "occupancy_max": [max(occupancy[l::levels])
                              for l in range(levels)]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="",
                    help="plant this fault of harness/faults.py in the port "
                    "(the program's readings are then the fault's)")
    ap.add_argument("--program-only", action="store_true",
                    help="the port's readings alone, without the control's")
    args = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    wl = {w["name"]: w for w in spec["workloads"]}[args.workload]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    if not torch.cuda.is_available():
        sys.exit("the control runs on the card")
    from temporal_latticenet_tpu_torch.ops import _cuda
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with (faults.plant(args.fault) if args.fault
              else contextlib.nullcontext()):
            r = reading(HERE, spec, args.workload, config, traffic, seed,
                        args.seconds, device, with_control=not (args.fault or args.program_only))
        r["fault"] = args.fault or None
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        lines.append(r)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
