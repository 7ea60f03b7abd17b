"""AFlow visualisation CLI of the PyTorch port (headless), mirroring the
repository's ``visualize_cli.py``: streams one sequence frame by frame with
the AFlow attention data recorded (``LNNSeq.sow_aux``) and writes, for
every frame after the first, the attention weights, the previous-frame
neighbor indices and the per-vertex mean positions to
``aflow_frame<t>.npz``; ``--render`` adds a matplotlib histogram of each
frame's weights.

    python -m temporal_latticenet_tpu_torch.visualize_cli \
        --config seq_config/lnn_eval_semantic_kitti.cfg \
        [--checkpoint ckpt.ckpt] --out aflow_vis/ [--seq-index 0] \
        [--render] [--device cpu]

Runs on CUDA unless ``--device`` names another device.  Only ``--render``
needs matplotlib."""

from __future__ import annotations

import argparse
import os


def run(config_file: str, checkpoint: str | None, out_dir: str,
        seq_index: int = 0, render: bool = False, datasets=None,
        device=None):
    import torch

    from .config import (cfgParser, model_config_from_cfg,
                         nr_classes_from_cfg, runtime_config_from_cfg)
    from .models.lnn_seq import LNNSeq, init_state
    from .train import checkpoint as ckpt
    from .train import loop
    from .utils import visualization as vis

    parser = cfgParser(config_file)
    cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
    rt = runtime_config_from_cfg(parser)
    if "aflow" not in cfg.rnn_modules:
        raise SystemExit("config has no aflow fusion module to visualise")

    model = LNNSeq(cfg, rt, device=device).eval()
    if checkpoint:
        ckpt.load(checkpoint, model, cfg=cfg)

    if datasets is None:
        datasets = loop.make_datasets(parser, cfg, rt, splits=("valid",))
    frames = datasets["valid"][seq_index]

    dev = model.device
    state = init_state(cfg, rt, dev, tables=True)
    os.makedirs(out_dir, exist_ok=True)
    for t, f in enumerate(frames):
        final = t == len(frames) - 1
        with torch.no_grad(), model.sow_aux() as sown:
            _, state, frame_aux = model(
                state, positions=torch.as_tensor(f.positions, device=dev),
                values=torch.as_tensor(f.values, device=dev),
                mask=torch.as_tensor(f.mask, device=dev), final=final)
        if t == 0:
            continue  # the first frame has no cross-frame attention
        keys = vis.export_aflow_arrays(
            os.path.join(out_dir, f"aflow_frame{t}.npz"), sown,
            f.positions, frame_aux["point_vertex"], rt.capacity_level0)
        print(f"frame {t}: wrote {len(keys)} arrays")

    if render:
        _render(out_dir, len(frames))
    return out_dir


def _render(out_dir: str, n_frames: int):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--render needs matplotlib, which is not "
                          "installed; without --render the .npz files are "
                          "written alone") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    for t in range(1, n_frames):
        path = os.path.join(out_dir, f"aflow_frame{t}.npz")
        if not os.path.exists(path):
            continue
        data = np.load(path)
        wkeys = [k for k in data.files if "aflow_weights" in k]
        if not wkeys:
            continue
        w = data[wkeys[0]]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(w[w > 0].ravel(), bins=50)
        ax.set_title(f"AFlow weights, frame {t}")
        ax.set_xlabel("weight")
        fig.savefig(os.path.join(out_dir, f"aflow_weights_frame{t}.png"),
                    dpi=120)
        plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write the AFlow attention "
                                 "data of one sequence.")
    ap.add_argument("--config",
                    default="seq_config/lnn_eval_semantic_kitti.cfg")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="./aflow_vis")
    ap.add_argument("--seq-index", type=int, default=0)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    a = ap.parse_args(argv)
    run(a.config, a.checkpoint, a.out, a.seq_index, a.render,
        device=a.device)


if __name__ == "__main__":
    main()
