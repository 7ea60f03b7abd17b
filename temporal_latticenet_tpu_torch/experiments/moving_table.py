"""The moving-class comparison table, from the results JSON of each
``train_lidar --moving 1`` variant.

The controlled experiment behind the table: identical dynamic-actor worlds
(``data/lidar_like.py``: actor-only car population, marginal-matched parked
counterparts) where motion across frames is the only signal separating
car/person (ids 1/6) from moving-car/moving-person (ids 20/22), the
26-class setting of the reference's ``semantic-kitti-all.yaml``.

    python -m temporal_latticenet_tpu_torch.experiments.moving_table \\
        [scale] --dir <directory of moving_<variant>_<scale>.json>

Writes ``moving_comparison_<scale>.md`` into that directory and prints it.
"""

from __future__ import annotations

import argparse
import json
import os

VARIANTS = [
    ("temporal", "flagship gru-gru-aflow-gru (4 frames)"),
    ("accum", "accumulated cloud (4 scans, no fusion)"),
    ("static", "single frame (sequence_learning=false)"),
]
CLASSES = ["car", "person", "road", "building", "trunk", "pole",
           "moving-car", "moving-person"]


def render(directory: str, scale: str) -> str:
    """The Markdown of the variants whose JSON is in ``directory``."""
    rows = []
    for v, desc in VARIANTS:
        path = os.path.join(directory, f"moving_{v}_{scale}.json")
        if not os.path.exists(path):
            print(f"missing {path}; skipping")
            continue
        with open(path) as f:
            rows.append((v, desc, json.load(f)))
    if not rows:
        raise SystemExit(f"no moving_<variant>_{scale}.json in {directory}")

    d0 = rows[0][2]
    worlds = d0.get("train_worlds_effective", d0["worlds"])
    lines = [
        "# Moving-class temporal evidence "
        f"({scale} scale, {worlds} train world(s) x "
        f"{d0.get('train_windows_per_epoch', '?')} windows/epoch, "
        f"{d0['epochs']} epochs; identical data for all variants)",
        "",
        "Held-out-world (valid) IoU per class; motion across frames is the",
        "only signal separating moving ids 20/22 from static ids 1/6",
        "(see data/lidar_like.py and tests/test_data.py's no-leak test).",
        "",
        "| variant | " + " | ".join(CLASSES) + " | mIoU | moving mean |",
        "|---|" + "---|" * (len(CLASSES) + 2),
    ]
    for v, desc, d in rows:
        iou = d["iou_valid"]
        moving = [iou.get("moving-car", 0.0), iou.get("moving-person", 0.0)]
        cells = [f"{iou.get(c, float('nan')):.3f}" for c in CLASSES]
        lines.append(
            f"| {v} ({desc}) | " + " | ".join(cells)
            + f" | {d['miou_valid']:.3f} | {sum(moving)/2:.3f} |")
    lines += [
        "",
        "Train-split mIoU: " + ", ".join(
            f"{v} {d['miou_train']:.3f}" for v, _, d in rows) + ".",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scale", nargs="?", default="small")
    ap.add_argument("--dir", default=".",
                    help="directory of the moving_<variant>_<scale>.json "
                         "files; the table is written there")
    args = ap.parse_args(argv)
    out = render(args.dir, args.scale)
    with open(os.path.join(args.dir,
                           f"moving_comparison_{args.scale}.md"), "w") as f:
        f.write(out)
    print(out)
    return out


if __name__ == "__main__":
    main()
