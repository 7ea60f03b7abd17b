"""One run of one cell: set-up, the measured window, the traced readings,
the correctness check and the result line (see ``benchmark/run.py``).

Everything that belongs to one configuration, traffic mix, loop, limit or
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the file the configuration's entry names):
  ``model``, ``runtime`` and ``train`` sections;
* ``traffic/<traffic>.json``: the pool, the generator's parameters and the
  ``loop`` that drives them;
* ``loops/<loop>.py``: a ``Loop`` class (set-up, window, one unit of work,
  the answers for the check);
* ``limits/<workload>.json``: the limit of each number compared;
* ``metrics/<metric>.py``, or ``metrics/<stem>.py`` for a metric named
  ``<stem>.<suffix>``: a ``read(ctx)`` that returns the metric's value or
  None when the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import resource
import sys
import time

import numpy as np
import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "temporal_latticenet_tpu")
PEAK_BF16_FLOPS = 989e12     # one H100 SXM, dense bf16 (NVIDIA's data sheet)


class RunError(RuntimeError):
    """A run that cannot give a result (exit 3, no result line)."""


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Context:
    """What a loop and a metric reader see of the run."""

    def __init__(self, bench_dir, workload, config, traffic, seed, device):
        from reference.config import ModelConfig as RefModel
        from reference.config import RuntimeConfig as RefRuntime
        from temporal_latticenet_tpu_torch.config import (ModelConfig,
                                                          RuntimeConfig)
        self.bench_dir, self.workload = bench_dir, workload
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        model, runtime = _tuples(config["model"]), config["runtime"]
        self.cfg, self.rt = ModelConfig(**model), RuntimeConfig(**runtime)
        self.ref_cfg = RefModel(**dict(model, compute_dtype="float32"))
        self.ref_rt = RefRuntime(**runtime)
        self.caps = self.rt.capacities(self.cfg.nr_downsamples)
        self.frames = self.cfg.frames_per_seq
        self.rng = np.random.default_rng([seed, 1])
        self.pool_size = traffic["pool"]
        self.order = [int(i) for i in self.rng.permutation(self.pool_size)]
        self.layer = {}

    def make_inputs(self):
        from harness.traffic import make_pool
        p, v, l, m = make_pool(self.traffic["generator"], self.pool_size,
                               self.frames, self.rt.max_points,
                               self.config.get("data", {}).get("cloud_scope",
                                                               1))
        self.points = m.sum(axis=2)                       # (pool, T)
        dev = self.device
        self.pos, self.val, self.lab, self.mask = (
            torch.as_tensor(a).to(dev) for a in (p, v, l, m))

    def make_weights(self):
        from harness.weights import make_weights
        from reference.models.lnn_seq import LNNSeq as RefLNN
        schema = RefLNN(self.ref_cfg, self.ref_rt, device="cpu")
        self.weights = make_weights(schema, self.seed, self.device)

    def port_model(self):
        from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
        model = LNNSeq(self.cfg, self.rt, device=self.device)
        model.load_state_dict(self.weights, strict=True)
        return model

    def ref_model(self, compute_dtype: str = "float32"):
        from reference import engine as ref
        cfg = dataclasses.replace(self.ref_cfg, compute_dtype=compute_dtype)
        return ref.build_model(cfg, self.ref_rt, self.weights,
                               self.device), cfg

    def sample(self, keys, n: int):
        """``n`` of ``keys`` drawn from the seed."""
        keys = sorted(keys)
        rng = np.random.default_rng([self.seed, 2])
        return [keys[i] for i in sorted(rng.choice(len(keys),
                                                   min(n, len(keys)),
                                                   replace=False))]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def level_rows(ctx: Context):
    """{pool index: ((T, L + 1) occupied vertices, (T,) valid points)} from
    the reference's lattice; fails the run when a level saturates."""
    from reference import engine as ref
    out = {}
    for k in range(ctx.pool_size):
        counts, pts = ref.level_counts(ctx.ref_cfg, ctx.ref_rt, ctx.pos[k],
                                       ctx.mask[k])
        full = [int(counts[:, l].max()) for l in range(counts.shape[1])]
        if any(c >= cap for c, cap in zip(full, ctx.caps)):
            raise RunError(f"sequence {k}: a vertex table saturates "
                           f"(occupancy {full}, capacities {list(ctx.caps)})")
        out[k] = ((counts - 1).tolist(), pts.tolist())
    return out


def host_probe_ms() -> float:
    """The host core's speed for Python: the best of five times of one fixed
    loop, in ms."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def window_flops(ctx: Context, loop, rows) -> float:
    from metrics.flops import frame_flops
    m = ctx.config["model"]
    t_last = ctx.frames - 1
    total = 0.0
    for k, t in loop.work:
        r, p = rows[k]
        total += frame_flops(m, r[t], p[t], t == 0, t == t_last)
    return total * getattr(loop, "flops_factor", 1)


def layer_metrics(ctx, spec, workload, reported) -> dict:
    out = {}
    for entry in spec["per_layer"]:
        cells = entry.get("workloads")
        if (workload not in cells) if cells is not None else (
                entry["moves"] not in reported):
            continue
        name = entry["name"]
        path = os.path.join(ctx.bench_dir, "metrics", f"{name}.py")
        if not os.path.exists(path):
            path = os.path.join(ctx.bench_dir, "metrics",
                                f"{name.split('.')[0]}.py")
        value = load_file(path, "metric_" + name.replace(".", "_")).read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": entry["unit"]}
    return out


def run_cell(bench_dir, spec, workload, config, traffic, limits, seed,
             seconds, trace, device, t_start) -> dict:
    """One run; returns the result line's object."""
    from harness import check
    from harness import trace as tr

    ctx = Context(bench_dir, workload, config, traffic, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        from temporal_latticenet_tpu_torch.ops import _cuda
        _cuda.build()
    ctx.make_inputs()
    ctx.make_weights()
    loop = load_file(os.path.join(bench_dir, "loops", f"{traffic['loop']}.py"),
                     "loop_" + traffic["loop"]).Loop(ctx)
    loop.setup()
    ctx.sync()
    # set-up's objects are not scanned again by the collector in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    probe = host_probe_ms()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    gc0 = sum(g["collections"] for g in gc.get_stats())
    e2e = loop.window(seconds)
    ctx.sync()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    gc1 = sum(g["collections"] for g in gc.get_stats())
    # what the host did to the run in its window (PERF.md section 6)
    print("host: probe %.2f ms, window user %.2f s, system %.2f s, "
          "switches %d voluntary, %d involuntary, %d collections"
          % (probe, ru1.ru_utime - ru0.ru_utime, ru1.ru_stime - ru0.ru_stime,
             ru1.ru_nvcsw - ru0.ru_nvcsw, ru1.ru_nivcsw - ru0.ru_nivcsw,
             gc1 - gc0), file=sys.stderr)
    unit_s = getattr(loop, "unit_s", [])
    if unit_s:
        q = np.percentile(unit_s, [0, 25, 50, 75, 100])
        print("window: %d units, seconds a unit min/q1/median/q3/max %s"
              % (len(unit_s), " ".join(f"{x:.4f}" for x in q)),
              file=sys.stderr)
    if forbidden_modules():
        raise RunError(f"modules loaded: {forbidden_modules()}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the reference's lattice, only once the peak is read
    rows = level_rows(ctx)
    reported = {"setup_s": setup_s, **e2e}
    mine = [m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]
    metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                "count": 1}
    if trace:
        if not cuda:
            raise RunError("--trace 1 needs the card")
        ctx.layer["window_s"] = loop.window_s
        ctx.layer["window_flops"] = window_flops(ctx, loop, rows)
        ctx.layer["peak_flops"] = PEAK_BF16_FLOPS
        ctx.sync()
        with tr.host_syncs() as syncs:
            frames = loop.unit()
            ctx.sync()
        ctx.layer["host_syncs"] = syncs[0] / loop.per(frames)
        red = tr.traced(loop.unit, loop.traced_units)
        red["per"] = loop.per(red["frames"])
        ctx.layer["trace"] = red
        metrics = layer_metrics(ctx, spec, workload, reported)
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": red["top_device_ops"],
                     "idle_gaps": red["idle_gaps"]}
    else:
        for m in mine:
            if m["name"] not in reported:
                raise RunError(f"the loop reports no {m['name']}")
            metrics[m["name"]] = {"value": reported[m["name"]],
                                  "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = peak
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, answers = loop.check()
    ok, checked = check.verdict(numbers, limits)
    out = {"correct": ok, "attempted": loop.attempted,
           "failed": 0 if ok else answers, "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    return out


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(bench_dir)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    wl = cells[args.workload]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"the cell needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    from harness.check import limits as read_limits
    lims = read_limits(bench_dir, args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = run_cell(bench_dir, spec, args.workload, config, traffic, lims,
                       args.seed, args.seconds, args.trace, device, t_start)
    except RunError as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 3
    if forbidden_modules():
        print(f"modules loaded: {forbidden_modules()}", file=sys.stderr)
        return 4
    for k, v in out["checked"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
