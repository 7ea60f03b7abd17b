"""Full-stack accuracy evidence on the port: overfit the flagship model on
a ray-cast LiDAR world and report train and valid mIoU through the loop,
the metrics, the prediction writer and the evaluator.

With no SemanticKITTI data at hand, a realistic-scale overfit run (the
reference's ``do_overfit`` fixture, lnn_train_semantic_kitti.cfg:104-105)
drives every layer: on-disk KITTI-format data -> loader (poses, LUT
remap) -> training loop (BPTT, AdamW, cosine restarts) -> ``Scores`` mIoU
-> ``.label`` writer.  Labels are deterministic functions of the geometry
(ground, building, trunk, pole, car), so a high mIoU is reachable and
meaningful.  It also measures the input pipeline: the loader's seconds
per sequence.  Runs on CUDA unless ``--cpu`` is given.

    python -m temporal_latticenet_tpu_torch.experiments.overfit_lidar \\
        [--epochs 30] [--capacity 49152] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..data.lidar_like import _make_world, _raycast_scan
from .train_lidar import raw_lut, write_scan, write_sequence_meta

# raw SemanticKITTI label ids for the lidar_like training-id classes
TRAIN_TO_RAW = {9: 40, 13: 50, 16: 71, 18: 80, 1: 10}

CFG_TEMPLATE = """
core: {{ loguru_verbosity: 3 }}
train: {{
    dataset_name: "semantickitti"
    batch_size: 1
    scheduler: "CosineAnnealingWarmRestarts"
    restart_epochs: 10
    lr: 0.001
    weight_decay: 1e-4
    training_epochs: {epochs}
    with_viewer: false
    with_visdom: false
    with_wandb: false
    save_checkpoint: true
    checkpoint_path: "{ckpt}"
    load_checkpoint: false
    load_checkpoint_model: ""
}}
eval: {{
    dataset_name: "semantickitti"
    with_viewer: false
    save_checkpoint: false
    checkpoint_path: "{ckpt}"
    load_checkpoint_model: ""
    do_write_predictions: true
    output_predictions_path: "{preds}"
}}
model: {{
    positions_mode: "xyz"
    values_mode: "reflectance"
    pointnet_layers: [16, 32, 64]
    pointnet_start_nr_channels: 64
    nr_downsamples: 2
    nr_blocks_down_stage: [2, 2, 2]
    nr_blocks_bottleneck: 3
    nr_blocks_up_stage: [1, 2, 2]
    nr_levels_down_with_normal_resnet: 3
    nr_levels_up_with_normal_resnet: 2
    compression_factor: 1.0
    dropout_last_layer: 0.0
    sequence_learning: true
    rnn_modules: ["gru", "gru", "aflow", "gru"]
    train_alpha_beta: true
    use_center: true
    experiment: "none"
}}
lattice_gpu: {{ hash_table_capacity: {cap}  nr_sigmas: 1  sigma_0: "0.6 3" }}
runtime: {{
    max_points: {max_points}
    capacity_level0: {cap}
    capacity_decay: 0.5
    min_capacity: {min_cap}
}}
loader_semantic_kitti: {{
    dataset_path: "{data}"
    accumulate_clouds: false
    frames_per_seq: 4
    cloud_scope: {scope}
    include_moving_classes: true
    sequences: "all"
    shuffle: true
    shuffle_points: false
    do_pose: true
    nr_clouds_to_skip: 0
    nr_clouds_to_read: 8
    cap_distance: -1
    min_distance: -1
    normalize: false
    do_overfit: false
    overfit_num_clouds: 100
    debug_loader: false
    seq_same_cloud: false
    label_mngr: {{ unlabeled_idx: 0 }}
    transformer: {{ }}
}}
"""


def write_world(root, n_scans=8, n_beams=64, n_az=2048):
    """Sequences 00 (train), 08 (valid) and 11 (test), each from its own
    world seed, driven by one scan-noise generator."""
    rng = np.random.default_rng(7)
    lut = raw_lut(TRAIN_TO_RAW)
    for seq in ("00", "08", "11"):
        world = _make_world(np.random.default_rng(100 + int(seq)))
        d = os.path.join(root, "sequences", seq)
        write_sequence_meta(d, n_scans)
        for s in range(n_scans):
            pts, lbl = _raycast_scan(world, np.array([1.0 * s, 0.02 * s]),
                                     0.01 * s, n_beams, n_az, rng)
            refl = np.clip(0.1 + 0.08 * (lbl % 7)
                           + 0.05 * rng.standard_normal(len(lbl)), 0, 1)
            write_scan(d, s, pts, refl, lbl, lut)
    return root


def main(argv=None) -> dict:
    """Write the world, time the loader, train, evaluate both splits
    (writing ``.label`` predictions); returns the results (also written
    to ``overfit_results.json`` under ``--root``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--scope", type=int, default=1,
                    help="cloud_scope (the flagship eval config uses 3)")
    ap.add_argument("--capacity", type=int, default=49152)
    ap.add_argument("--root", type=str, default="",
                    help="world, cfg, checkpoints and predictions (default: "
                         "overfit_lidar in the temporary directory)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scans and capacities for a fast check")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    root = args.root or os.path.join(tempfile.gettempdir(), "overfit_lidar")

    if args.smoke:
        beams, n_az, max_points, min_cap = 16, 512, 8192, 2048
        args.capacity = 8192
    else:
        beams, n_az, max_points, min_cap = 64, 2048, 131072, 8192

    os.makedirs(root, exist_ok=True)
    data = write_world(os.path.join(root, "data"), n_beams=beams, n_az=n_az)
    ckpt_dir = os.path.join(root, "ckpt")
    preds = os.path.join(root, "preds")
    os.makedirs(ckpt_dir, exist_ok=True)
    cfg_path = os.path.join(root, "cfg.cfg")
    with open(cfg_path, "w") as f:
        f.write(CFG_TEMPLATE.format(epochs=args.epochs, cap=args.capacity,
                                    ckpt=ckpt_dir, preds=preds, data=data,
                                    max_points=max_points, min_cap=min_cap,
                                    scope=args.scope))

    from ..config import (cfgParser, model_config_from_cfg,
                          nr_classes_from_cfg, runtime_config_from_cfg)
    from ..data.kitti import SemanticKittiDataset
    from ..train import loop

    # the input pipeline: the loader's seconds per sequence
    parser = cfgParser(cfg_path)
    cfg = model_config_from_cfg(parser, nr_classes_from_cfg(parser))
    rt = runtime_config_from_cfg(parser)
    datasets = loop.make_datasets(parser, cfg, rt, splits=("train", "valid"))
    # a valid phase of 2 windows an epoch, so that epochs are mostly training
    lc_small = dict(parser.get_loader_vars())
    lc_small["nr_clouds_to_read"] = 2
    datasets["valid"] = SemanticKittiDataset(
        "valid", lc_small, parser.get_model_vars(), cfg.sequence_learning,
        max_points=rt.max_points)
    ds = datasets["train"]
    t0 = time.perf_counter()
    for i in range(len(ds)):
        _ = ds[i]
    loader_s_per_seq = (time.perf_counter() - t0) / len(ds)
    print(f"loader: {loader_s_per_seq:.3f} s/sequence over {len(ds)} seqs",
          flush=True)

    t0 = time.perf_counter()
    loop.run_training(cfg_path, datasets=datasets, device=device)
    train_s = time.perf_counter() - t0
    n_steps = args.epochs * len(ds)
    print(f"training wall {train_s:.0f}s (~{train_s / max(n_steps, 1):.2f} "
          f"s/step incl. valid)", flush=True)

    ckpts = sorted((os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                    if f.endswith(".ckpt")), key=os.path.getmtime)
    latest = ckpts[-1]
    print("using checkpoint:", latest, flush=True)

    # evaluation through the writer and the metrics
    results = {"loader_s_per_seq": loader_s_per_seq,
               "train_wall_s": train_s, "epochs": args.epochs,
               "capacity": args.capacity}
    for split in ("train", "valid"):
        miou, _ = loop.run_eval(cfg_path, split=split, datasets=datasets,
                                checkpoint_path=latest, device=device)
        results[f"miou_{split}"] = float(miou)
        print(f"{split} mIoU: {miou:.4f}", flush=True)

    with open(os.path.join(root, "overfit_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
