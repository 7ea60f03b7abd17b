"""Which device events a ``torch.profiler`` window of the PyTorch port's
flagship forward loses, and why (needs a CUDA card).

    python scripts/torch_profiler_windows.py [--rounds N] [--pause S]
        [--kinds K,...] [--out FILE]

Builds the hand-written kernels, then profiles one flagship forward at the
geometry of ``chip_smoke.py`` phase 4 (131,072 points a frame) in windows
of the given kinds, taken in turn for ``--rounds`` rounds in one process,
with ``--pause`` seconds of sleep after each round (the process ages):

* ``spans``: ``utils.profiling.window`` without a warm-up step (recording
  from the session's start), the port's spans (``utils.profiling.span``)
  on;
* ``no_spans``: the same with the spans off
  (``utils.profiling.without_spans``);
* ``warm_up_N``: ``utils.profiling.window(warm_up_launches=N,
  settle_s=0)``, whose recording starts after a discarded warm-up step of
  N one-element operations on the card, spans on;
* ``warm_up_N_settle_M``: the same, with the forward started M ms after
  the recording (``settle_s``).

For each window it prints, from the exported Chrome trace: the device
events (kernels, copies, memsets), the hand-written kernels by name, the
runtime launches whose device event is missing and their places among the
window's launches, and the smallest gap between a launch and its device
event (a negative gap would mean the two clocks disagree).  The last line
is a JSON summary per kind.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from temporal_latticenet_tpu_torch.ops import _cuda  # noqa: E402
from temporal_latticenet_tpu_torch.utils import profiling  # noqa: E402

OUT_DIR = ROOT / "build" / "profiler_windows"
LAUNCH = ("LaunchKernel", "Memcpy", "Memset")


def read_trace(path: Path) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime = sorted((e for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and any(w in e.get("name", "") for w in LAUNCH)),
                     key=lambda e: e["ts"])
    by_corr = {e["args"].get("correlation"): e for e in device}
    missing = [(i, e["name"]) for i, e in enumerate(runtime)
               if e["args"].get("correlation") not in by_corr]
    gaps = [by_corr[e["args"]["correlation"]]["ts"] - e["ts"]
            for e in runtime if e["args"].get("correlation") in by_corr]
    hand = {}
    for e in device:
        k = cs.hand_written(e["name"])
        if k:
            hand[k] = hand.get(k, 0) + 1
    return dict(device_events=len(device), launches=len(runtime),
                hand_written=hand, missing=len(missing),
                missing_at=[i for i, _ in missing[:8]],
                missing_names=sorted({n for _, n in missing}),
                min_gap_us=min(gaps) if gaps else None)


def window(kind: str):
    if kind.startswith("warm_up_"):
        parts = kind.split("_")
        settle_ms = int(parts[4]) if len(parts) > 4 else 0
        return profiling.window(warm_up_launches=int(parts[2]),
                                settle_s=settle_ms / 1e3)
    return profiling.window(warm_up_launches=0, settle_s=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--pause", type=float, default=0.0,
                    help="seconds to sleep after each round (process age)")
    ap.add_argument("--kinds", default="spans,no_spans,warm_up_2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print(_cuda.build())
    dev = torch.device("cuda")
    data = cs.lidar(cs.FLAGSHIP_RT["max_points"])
    _, fwd, _ = cs.make_forward(cs.FLAGSHIP_RT, dev)
    with torch.no_grad():
        fwd(*data)
        fwd(*data)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    kinds = args.kinds.split(",")
    rows = []
    for r in range(args.rounds):
        for j in range(len(kinds)):
            kind = kinds[(r + j) % len(kinds)]     # rotate the order
            spans = profiling.without_spans() if kind == "no_spans" \
                else contextlib.nullcontext()
            _cuda.reset_launch_counts()
            with spans, torch.no_grad(), window(kind) as prof:
                fwd(*data)
            launched = _cuda.launch_counts()
            path = OUT_DIR / f"{r}_{kind}.json"
            prof.export_chrome_trace(str(path))
            row = dict(round=r, kind=kind,
                       age_s=round(time.perf_counter() - t_start, 1),
                       **read_trace(path))
            row["k1_seen"] = row["hand_written"].get("fused_simplex_pack", 0)
            row["k1_launched"] = launched["fused_simplex_pack"]
            path.unlink()
            rows.append(row)
            print(json.dumps(row), flush=True)
        time.sleep(args.pause)
    summary = {}
    for kind in kinds:
        mine = [x for x in rows if x["kind"] == kind]
        summary[kind] = dict(
            windows=len(mine),
            windows_missing_events=sum(x["missing"] > 0 for x in mine),
            windows_missing_k1=sum(x["k1_seen"] < x["k1_launched"]
                                   for x in mine),
            missing_events=[x["missing"] for x in mine],
            median_device_events=statistics.median(
                x["device_events"] for x in mine),
            min_gap_us=min(x["min_gap_us"] for x in mine
                           if x["min_gap_us"] is not None))
    line = cs.device_line()
    if args.out:
        Path(args.out).write_text(json.dumps(dict(device=line, rows=rows,
                                                  summary=summary)))
    print(line)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
