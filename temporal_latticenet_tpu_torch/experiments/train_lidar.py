"""Multi-world LiDAR training on the port: the generalization run and the
moving-class comparison.

Worlds from the ray caster (``data/lidar_like.py``) are written in the
SemanticKITTI on-disk format and driven through the loader, the training
loop (``train/loop.run_training``), the metrics and ``run_eval``:

* generalization (``--variant temporal --moving 0``): train the flagship on
  N train worlds, validate on a held-out world (a fresh world seed of the
  same generator);
* moving-class (``--moving 1``): worlds hold dynamic actors (moving cars,
  id 20, and moving pedestrians, id 22, of the 26-class setting) and
  geometrically identical static counterparts (ids 1 and 6).  Motion
  across frames is the only signal that separates 1 from 20 and 6 from
  22, so the three variants are the paper's central comparison:

    --variant temporal   flagship gru-gru-aflow-gru    (can separate)
    --variant static     sequence_learning=false       (cannot beat prior)
    --variant accum      accumulate_clouds=true        (sees smear only)

Writes a JSON of train and valid mIoU with per-class IoUs.  Runs on CUDA
unless ``--cpu`` is given.

    python -m temporal_latticenet_tpu_torch.experiments.train_lidar \\
        --variant temporal --moving 1 --epochs 30 --scale small \\
        --out results/moving_temporal_small.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time

import numpy as np

from ..data.lidar_like import (_make_actors, _make_world, _raycast_scan,
                               _static_counterparts, material_class)

# lidar_like training ids -> raw SemanticKITTI labels (the loader's LUT
# inverts them)
TRAIN_TO_RAW = {9: 40, 13: 50, 16: 71, 18: 80, 1: 10, 6: 30, 20: 252,
                22: 254}

SCALES = {
    # name: (n_beams, n_az, max_points, cap0, min_cap)
    "full": (64, 2048, 131072, 49152, 8192),
    # medium: an azimuth sweep dense enough (0.12 m column spacing at 20 m)
    # that pedestrian-sized actors return several columns per scan; its
    # capacities sit above the worst-case moving=0 union occupancy that
    # occupancy_worlds measures at this scale
    "medium": (64, 1024, 65536, 49152, 12288),
    # small: coarse-level occupancy shrinks with the swept area, not the
    # point count, so it stays near the full-scale figures; dynamic actors
    # sweep extra union cells
    "small": (64, 512, 32768, 32768, 8192),
    "smoke": (16, 256, 4096, 4096, 1024),
}

CFG_TEMPLATE = """
core: {{ loguru_verbosity: 3 }}
train: {{
    dataset_name: "semantickitti"
    batch_size: 1
    scheduler: "CosineAnnealingWarmRestarts"
    restart_epochs: {restart_epochs}
    lr: 0.001
    weight_decay: 1e-4
    training_epochs: {epochs}
    with_viewer: false
    with_visdom: false
    with_wandb: false
    save_checkpoint: true
    checkpoint_path: "{ckpt}"
    load_checkpoint: {load_ckpt}
    load_checkpoint_model: "{load_model}"
    start_epoch: {start_epoch}
}}
eval: {{
    dataset_name: "semantickitti"
    with_viewer: false
    save_checkpoint: false
    checkpoint_path: "{ckpt}"
    load_checkpoint_model: ""
    do_write_predictions: false
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
    sequence_learning: {seq_learning}
    rnn_modules: {rnn_modules}
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
    remat_mode: "{remat}"
}}
loader_semantic_kitti: {{
    dataset_path: "{data}"
    accumulate_clouds: {accum}
    frames_per_seq: {frames}
    cloud_scope: {scope}
    include_moving_classes: true
    sequences: "all"
    shuffle: true
    shuffle_points: false
    do_pose: true
    nr_clouds_to_skip: 0
    nr_clouds_to_read: -1
    measure_sequence_lengths: true
    cap_distance: -1
    min_distance: -1
    normalize: false
    do_overfit: false
    overfit_num_clouds: 100
    debug_loader: false
    seq_same_cloud: false
    label_mngr: {{ unlabeled_idx: 0 }}
    transformer: {{ {aug} }}
}}
"""

# the reference's train-time augmentation (lnn_train_semantic_kitti.cfg:
# 118-133): vertical-axis rotation, mirrors and 90-degree spins, and an xz
# translation, drawn once per sequence window
AUG_BLOCK = """
        random_translation_xz_magnitude: 20.0
        rotation_y_max_angle: 10.0
        random_mirror_x: true
        random_mirror_z: true
        random_rotation_90_degrees_y: true
"""

# the KITTI split (data/kitti_meta.py): 00-07, 09, 10 train; 08 valid
TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VALID_SEQS = ["08"]

CLASS_NAMES = {1: "car", 6: "person", 9: "road", 13: "building",
               16: "trunk", 18: "pole", 20: "moving-car",
               22: "moving-person"}

VARIANTS = ("temporal", "static", "accum")
FLAGSHIP_RNN = ["gru", "gru", "aflow", "gru"]


def raw_lut(train_to_raw: dict) -> np.ndarray:
    """Training id -> raw SemanticKITTI label."""
    lut = np.zeros(260, np.uint32)
    for tr, raw in train_to_raw.items():
        lut[tr] = raw
    return lut


def write_sequence_meta(d: str, n_scans: int, speed: float = 1.0) -> None:
    """``calib.txt`` (identity) and ``poses.txt`` of a sensor driving
    ``speed`` m per scan along x with a slight drift in y."""
    os.makedirs(os.path.join(d, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(d, "labels"), exist_ok=True)
    eye = "1 0 0 0 0 1 0 0 0 0 1 0"
    with open(os.path.join(d, "calib.txt"), "w") as f:
        f.write(f"P0: {eye}\nTr: {eye}\n")
    with open(os.path.join(d, "poses.txt"), "w") as f:
        for s in range(n_scans):
            f.write(f"1 0 0 {speed * s} 0 1 0 {0.02 * s} 0 0 1 0\n")


def write_scan(d: str, s: int, pts: np.ndarray, refl: np.ndarray,
               lbl: np.ndarray, lut: np.ndarray) -> None:
    """Scan ``s`` as ``velodyne/<s>.bin`` (x, y, z, reflectance float32)
    and ``labels/<s>.label`` (raw uint32)."""
    arr = np.concatenate([pts, refl[:, None].astype(np.float32)], 1)
    arr.astype(np.float32).tofile(os.path.join(d, "velodyne", f"{s:06d}.bin"))
    lut[lbl].astype(np.uint32).tofile(
        os.path.join(d, "labels", f"{s:06d}.label"))


def write_moving_world(root, seq, n_scans, n_beams, n_az, moving, seed,
                       speed=1.0):
    """One on-disk KITTI sequence from a fresh world; actors move per scan."""
    wrng = np.random.default_rng(seed)
    rng = np.random.default_rng(seed + 1)
    # moving worlds: cars exist only as actors and their matched parked
    # counterparts (a background car population, spread differently, would
    # hand a single-frame model a spatial prior; see lidar_like._make_world)
    world = _make_world(wrng, include_cars=not moving)
    actors = None
    if moving:
        actors = _make_actors(wrng, 16, 12)
        sc, sr, sh, scls = _static_counterparts(wrng, 16, 12,
                                                smear_scans=n_scans)
        world = (np.concatenate([world[0], sc]),
                 np.concatenate([world[1], sr]),
                 np.concatenate([world[2], sh]),
                 np.concatenate([world[3], scls]))

    lut = raw_lut(TRAIN_TO_RAW)
    d = os.path.join(root, "sequences", seq)
    write_sequence_meta(d, n_scans, speed)
    for s in range(n_scans):
        frame_world = world
        if actors is not None:
            ac, ar, ah, acls, av = actors
            frame_world = (np.concatenate([world[0], ac + av * s]),
                           np.concatenate([world[1], ar]),
                           np.concatenate([world[2], ah]),
                           np.concatenate([world[3], acls]))
        pts, lbl = _raycast_scan(frame_world,
                                 np.array([speed * s, 0.02 * s]),
                                 0.01 * s, n_beams, n_az, rng)
        # reflectance from the material (a moving id shares its static
        # counterpart's): the raw label would leak moving-vs-static to a
        # single-frame model
        refl = np.clip(0.1 + 0.08 * (material_class(lbl) % 7)
                       + 0.05 * rng.standard_normal(len(lbl)), 0, 1)
        write_scan(d, s, pts, refl, lbl, lut)


def world_stamp(worlds: int, scans: int, scale: str, moving: int) -> dict:
    """What ``GENERATED.json`` records of the written worlds."""
    beams, n_az = SCALES[scale][:2]
    return {"worlds": worlds, "scans": scans, "beams": beams, "n_az": n_az,
            "moving": moving, "refl": "material-v2",
            "geom": "actor-only-cars-v3"}


def write_worlds(data: str, worlds: int, scans: int, scale: str, moving: int,
                 fresh: bool = False) -> bool:
    """The train worlds and the valid world under ``data``, unless its
    ``GENERATED.json`` already records the same ones; True if written."""
    stamp = os.path.join(data, "GENERATED.json")
    want = world_stamp(worlds, scans, scale, moving)
    if not fresh and os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == want:
                return False
    beams, n_az = SCALES[scale][:2]
    t0 = time.perf_counter()
    for seq in TRAIN_SEQS[:worlds] + VALID_SEQS:
        write_moving_world(data, seq, scans, beams, n_az, bool(moving),
                           seed=1000 + int(seq))
    os.makedirs(data, exist_ok=True)
    with open(stamp, "w") as f:
        json.dump(want, f)
    print(f"wrote {worlds}+1 worlds in {time.perf_counter() - t0:.0f}s",
          flush=True)
    return True


def format_cfg(variant: str, *, epochs: int, scale: str, scope: int,
               aug: int, frames: int, rnn: str, remat: str, ckpt: str,
               preds: str, data: str, load_ckpt: str = "false",
               load_model: str = "", start_epoch: int = 0) -> str:
    """The run's ``.cfg`` text.

    ``static`` turns ``sequence_learning`` off (one frame, no fusion);
    ``accum`` keeps it on, since the loader reads a ``frames_per_seq``
    window only with sequence learning and ``accumulate_clouds`` collapses
    that window to one concatenated cloud (with it off, the "accumulated"
    cloud would be one scan).  Its rnn modules stay the flagship's, so the
    parameters match the temporal variant's; with one frame they carry no
    temporal information.  The accumulated cloud holds the whole window,
    so ``accum`` takes four times the points (without them the loader's
    drop-oldest would cut it to about one scan); the union, and so the
    capacities, stay the same."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    _, _, max_points, cap0, min_cap = SCALES[scale]
    if variant == "accum":
        max_points *= 4
    if variant == "static":
        mods = ["none"] * 4
    else:
        mods = rnn.split(",") if rnn else FLAGSHIP_RNN
    return CFG_TEMPLATE.format(
        epochs=epochs, restart_epochs=max(epochs // 3, 5),
        cap=cap0, ckpt=ckpt, preds=preds, data=data,
        max_points=max_points, min_cap=min_cap, scope=scope,
        aug=AUG_BLOCK if aug else "",
        frames=frames if variant != "static" else 1,
        seq_learning="false" if variant == "static" else "true",
        rnn_modules="[" + ", ".join(f'"{m.strip()}"' for m in mods) + "]",
        accum="true" if variant == "accum" else "false",
        remat=remat, load_ckpt=load_ckpt, load_model=load_model,
        start_epoch=start_epoch)


def newest_epoch_checkpoint(ckpt_dir: str):
    """(epoch, file name) of the highest ``_epoch<N>.ckpt``, or None."""
    done = sorted((int(m.group(1)), f) for f in os.listdir(ckpt_dir)
                  if (m := re.search(r"_epoch(\d+)\.ckpt$", f)))
    return done[-1] if done else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=VARIANTS, default="temporal")
    ap.add_argument("--moving", type=int, default=1)
    ap.add_argument("--worlds", type=int, default=8,
                    help="number of train worlds (sequences)")
    ap.add_argument("--scans", type=int, default=10, help="scans per world")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--scope", type=int, default=1)
    ap.add_argument("--aug", type=int, default=0,
                    help="1 = reference train-time augmentation (AUG_BLOCK)")
    ap.add_argument("--rnn", type=str, default="",
                    help="comma list overriding the temporal variant's rnn "
                         "modules (e.g. gru,gru,gru,gru)")
    ap.add_argument("--frames", type=int, default=4,
                    help="frames per sequence window")
    ap.add_argument("--scale", choices=tuple(SCALES), default="small")
    ap.add_argument("--remat", choices=("full", "selective", "none"),
                    default="full", help="BPTT remat mode (runtime section)")
    ap.add_argument("--root", type=str, default="",
                    help="worlds, cfgs and checkpoints (default: "
                         "train_lidar_<scale>_m<moving> in the temporary "
                         "directory)")
    ap.add_argument("--out", type=str, default="",
                    help="results JSON (default: lidar_<variant>_m<moving>_"
                         "<scale>.json under --root)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest per-epoch checkpoint in "
                         "this run's checkpoint directory")
    ap.add_argument("--fresh-data", action="store_true",
                    help="regenerate the on-disk worlds even if present")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights and the shuffle (0: "
                         "the JAX script's fixed draw)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Write the worlds, train, evaluate both splits; returns the results
    (also written to ``--out``)."""
    from ..train import loop

    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    root = args.root or os.path.join(
        tempfile.gettempdir(), f"train_lidar_{args.scale}_m{args.moving}")
    data = os.path.join(root, "data")
    write_worlds(data, args.worlds, args.scans, args.scale, args.moving,
                 args.fresh_data)

    ckpt_dir = os.path.join(root, f"ckpt_{args.variant}")
    preds = os.path.join(root, "preds")
    os.makedirs(ckpt_dir, exist_ok=True)

    load_ckpt, load_model, start_epoch = "false", "", 0
    if args.resume:
        last = newest_epoch_checkpoint(ckpt_dir)
        if last:
            last_epoch, load_model = last
            load_ckpt, start_epoch = "true", last_epoch + 1
            print(f"resuming from epoch {last_epoch} ({load_model})",
                  flush=True)

    cfg_path = os.path.join(root, f"cfg_{args.variant}.cfg")
    with open(cfg_path, "w") as f:
        f.write(format_cfg(
            args.variant, epochs=args.epochs, scale=args.scale,
            scope=args.scope, aug=args.aug, frames=args.frames, rnn=args.rnn,
            remat=args.remat, ckpt=ckpt_dir, preds=preds, data=data,
            load_ckpt=load_ckpt, load_model=load_model,
            start_epoch=start_epoch))

    t0 = time.perf_counter()
    loop.run_training(cfg_path, device=device, seed=args.seed)
    train_s = time.perf_counter() - t0
    print(f"training wall {train_s:.0f}s", flush=True)

    ckpts = sorted((os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                    if f.endswith(".ckpt")), key=os.path.getmtime)
    latest = ckpts[-1]
    print("using checkpoint:", latest, flush=True)

    results = {"variant": args.variant, "moving": args.moving,
               "worlds": args.worlds, "scans": args.scans,
               "train_windows_per_epoch": args.worlds * args.scans,
               "epochs": args.epochs, "scale": args.scale,
               "scope": args.scope, "train_wall_s": train_s,
               "checkpoint": latest}
    for split in ("train", "valid"):
        miou, phase = loop.run_eval(cfg_path, split=split,
                                    checkpoint_path=latest, device=device)
        per_class = phase.scores.iou_per_class()
        results[f"miou_{split}"] = float(miou)
        results[f"iou_{split}"] = {
            CLASS_NAMES.get(int(k), str(k)): float(v)
            for k, v in per_class.items()}
        print(f"{split} mIoU {miou:.4f}  per-class "
              f"{results[f'iou_{split}']}", flush=True)

    out = args.out or os.path.join(
        root, f"lidar_{args.variant}_m{args.moving}_{args.scale}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
