"""Headless prediction renderer of the PyTorch port, mirroring the
repository's ``record_plys.py``: side-by-side figure frames from saved
``.label`` predictions (the reference's ``RecordPLYs.py`` +
``create_movie.sh``).  It loads scans from a SemanticKITTI layout, colors
them by (a) the predictions, (b) an optional comparison method's
predictions, (c) ground truth, renders top-down matplotlib views side by
side, and writes numbered PNGs (``ffmpeg -framerate 10 -i frame_%05d.png
movie.mp4`` makes the movie).

    python -m temporal_latticenet_tpu_torch.record_plys \
        --dataset-path /data/kitti --sequence 8 --predictions ./predictions \
        [--compare ./other_preds] [--start 0 --count 100] --out ./frames

Host code only (numpy and matplotlib); ``run`` needs matplotlib."""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_pred_labels(pred_root: str, seq: int, scan: int) -> np.ndarray | None:
    p = os.path.join(pred_root, "sequences", f"{seq:02d}", "predictions",
                     f"{scan:06d}.label")
    if not os.path.exists(p):
        return None
    return np.fromfile(p, dtype=np.uint32).astype(np.int64)


def render_frame(ax, xyz, colors, title, lim=50.0):
    ax.scatter(xyz[:, 0], xyz[:, 1], s=0.3, c=colors, linewidths=0)
    ax.set_title(title, fontsize=9)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.axis("off")


def run(dataset_path: str, sequence: int, predictions: str, out: str,
        compare: str | None = None, start: int = 0, count: int = 50,
        include_moving: bool = True, max_points_plot: int = 60000):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("record_plys renders with matplotlib, which is "
                          "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .data import kitti_meta
    from .utils.label_mngr import LabelMngr

    mngr = LabelMngr(dataset="semantickitti", include_moving=include_moving)
    lut = kitti_meta.build_remap_lut(include_moving)
    os.makedirs(out, exist_ok=True)

    for i, scan in enumerate(range(start, start + count)):
        seq_dir = os.path.join(dataset_path, "sequences", f"{sequence:02d}")
        bin_path = os.path.join(seq_dir, "velodyne", f"{scan:06d}.bin")
        if not os.path.exists(bin_path):
            break
        xyz = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)[:, :3]

        lab_path = os.path.join(seq_dir, "labels", f"{scan:06d}.label")
        gt = None
        if os.path.exists(lab_path):
            gt = lut[np.fromfile(lab_path, dtype=np.uint32) & 0xFFFF]

        panels = []
        pred = load_pred_labels(predictions, sequence, scan)
        if pred is not None:
            panels.append(("ours", pred))
        if compare:
            other = load_pred_labels(compare, sequence, scan)
            if other is not None:
                panels.append(("comparison", other))
        if gt is not None:
            panels.append(("ground truth", gt))
        if not panels:
            continue

        sel = (np.random.default_rng(0).choice(xyz.shape[0], max_points_plot,
                                               False)
               if xyz.shape[0] > max_points_plot else slice(None))
        fig, axes = plt.subplots(1, len(panels),
                                 figsize=(5 * len(panels), 5), dpi=110)
        if len(panels) == 1:
            axes = [axes]
        for ax, (title, labels) in zip(axes, panels):
            render_frame(ax, xyz[sel],
                         mngr.color_from_label_indices(labels[sel]),
                         f"{title} (scan {scan})")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"frame_{i:05d}.png"))
        plt.close(fig)
    print(f"wrote frames to {out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Render saved predictions.")
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--sequence", type=int, default=8)
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--out", default="./movie_frames")
    a = ap.parse_args(argv)
    run(a.dataset_path, a.sequence, a.predictions, a.out, a.compare, a.start,
        a.count)


if __name__ == "__main__":
    main()
