"""Host-side training and evaluation loop of the PyTorch port: the
``run_training`` / ``run_eval`` of the JAX package's ``train/loop.py``
over the port's training step and forward, driven by one ``.cfg`` file.

They run on CUDA unless ``device`` asks for the CPU, and never fall back to
the CPU on their own.  Per step the host reads what the JAX loop reads, in
the same order: the (B, P) int32 predictions (an argmax on the device),
the loss and the other logged metrics, then ``vertex_overflow``.

``train.batch_size`` is the global count of sequences per optimizer step:
without a mesh one device runs them all, with a ``parallel.mesh.Mesh`` each
rank runs ``batch_size / world_size`` of them (every rank draws the same
shuffle and takes its own stride of it, cut to a common length, as the JAX
loop's processes do), and only rank 0 writes checkpoints, CSVs, plots and
traces.  The valid phase is not split: every rank runs all of it.

Differences from the JAX loop: ``core.debug_with_profiler`` traces with
``torch.profiler`` (``utils/profiling.trace``), and the submission check
after a full split is this package's :func:`evaluate_semantics.validate`.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from ..config import (ModelConfig, RuntimeConfig, cfgParser,
                      model_config_from_cfg, nr_classes_from_cfg,
                      runtime_config_from_cfg)
from ..data.kitti import SemanticKittiDataset
from ..device import resolve_device
from ..parallel import mesh as pmesh
from ..utils import profiling
from . import checkpoint as ckpt
from . import engine, optim
from .callbacks import CallbacksGroup, Phase, StateCallback, WandBCallback


def _prefetch(iterable, depth: int = 2):
    """Background-thread prefetch of assembled windows (the reference's 8
    loader workers, upstream train_ln.py:56-57): window assembly and
    augmentation overlap the device's work.  An exception in the thread is
    raised in the caller.  Closing the generator (a caller that stops
    early) stops the thread and joins it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            put(e)
        finally:
            put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _sequence_order(n: int, shuffle: bool, rng: np.random.Generator,
                    mesh=None):
    """Epoch order of sequence indices; with a ``mesh``, this rank's share.

    Every rank draws the same shuffle (the same seed), then rank r takes
    indices ``r::world_size``, cut to a common length so that every rank
    runs the same number of steps (a rank with one step more would wait in
    the gradient all-reduce forever)."""
    order = np.arange(n)
    if shuffle:
        rng.shuffle(order)
    if mesh is not None and mesh.world_size > 1:
        per = n // mesh.world_size
        order = order[mesh.rank::mesh.world_size][:per]
    return order


def _grouped(items, k: int):
    """Consecutive groups of ``k`` items; a shorter remainder is dropped
    (a step needs a full batch; the next epoch's shuffle brings it back)."""
    buf = []
    for item in items:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []


def make_datasets(parser: cfgParser, cfg: ModelConfig, rt: RuntimeConfig,
                  splits=("train", "valid")):
    lc = parser.get_loader_vars()
    mc = parser.get_model_vars()
    if parser._dataset_name() == "parislille":
        from ..data.parislille import ParisLille3DDataset
        ds_cls = ParisLille3DDataset
    else:
        ds_cls = SemanticKittiDataset
    return {
        s: ds_cls(s, lc, mc, cfg.sequence_learning, max_points=rt.max_points)
        for s in splits
    }


def _predict(logp: torch.Tensor) -> np.ndarray:
    """Argmax on the device, then one copy of the (B, P) int32 labels."""
    return torch.argmax(logp, dim=-1).to(torch.int32).cpu().numpy()


def _host_dict(tensors: dict | None) -> dict | None:
    """{name: 0-d tensor} -> {name: float} in one copy to the host."""
    if tensors is None:
        return None
    return dict(zip(tensors, torch.stack(list(tensors.values())).tolist()))


def _setup(parser: cfgParser, device):
    nr_classes = nr_classes_from_cfg(parser)
    cfg = model_config_from_cfg(parser, nr_classes)
    rt = runtime_config_from_cfg(parser)
    return cfg, rt, resolve_device(device)


def run_training(config_file: str, max_steps: int | None = None,
                 datasets=None, device=None, mesh=None, seed: int = 0):
    """Train from ``config_file``; returns ``(model, state)``.

    ``max_steps`` stops after that many steps (train and valid counted
    together, as in the JAX loop); ``datasets`` ({"train", "valid"})
    replaces the cfg's.  With a ``parallel.mesh.Mesh`` the model lives on
    the rank's device (``device`` is not used) and the train phase is split
    over the ranks.  ``seed`` draws the initial weights and the epochs'
    shuffle; 0 is the JAX loop's fixed seed."""
    parser = cfgParser(config_file)
    train_cfg = parser.get_train_vars()
    loader_cfg = parser.get_loader_vars()
    label_cfg = parser.get_label_mngr_vars()
    ignore_index = label_cfg.get("unlabeled_idx", 0)
    cfg, rt, dev = _setup(parser, mesh.device if mesh is not None else device)
    world = mesh.world_size if mesh is not None else 1
    root = mesh is None or mesh.rank == 0

    bs = int(train_cfg.get("batch_size", 1))
    if bs % world:
        raise ValueError(f"train.batch_size={bs} does not split over "
                         f"{world} ranks")

    model, state = engine.create_train_state(
        cfg, rt, lr=train_cfg["lr"], weight_decay=train_cfg["weight_decay"],
        seed=seed, device=dev)
    train_step, eval_step = engine.make_train_step(
        model, cfg, rt, ignore_index,
        # per-parameter gradient norms (wandb.watch's analog); only paid
        # for when wandb is on
        watch_grads=bool(train_cfg.get("with_wandb")), mesh=mesh)

    if datasets is None:
        datasets = make_datasets(parser, cfg, rt)

    if train_cfg.get("load_checkpoint"):
        path = os.path.join(train_cfg["checkpoint_path"],
                            train_cfg["load_checkpoint_model"])
        state.step = ckpt.load(path, model, state.optimizer, cfg=cfg)
        print("loaded checkpoint:", path)
    if mesh is not None:
        pmesh.replicate(mesh, model)
        if root:
            print(f"data parallel: {bs} sequences/step over {world} ranks")

    cbs = [StateCallback()]
    if root and train_cfg.get("with_wandb"):
        cbs.append(WandBCallback("temporal_latticenet_tpu", parser.contents))
    if root and train_cfg.get("with_visdom"):
        from .callbacks import PlotCallback
        cbs.append(PlotCallback(os.path.join(
            train_cfg.get("checkpoint_path", "."), "plots")))
    cb = CallbacksGroup(cbs)
    save = root and train_cfg.get("save_checkpoint")

    # core.debug_with_profiler: a torch.profiler trace of the first epoch
    trace = contextlib.ExitStack()
    if root and parser.get_core_vars().get("debug_with_profiler"):
        trace.enter_context(profiling.trace(os.path.join(
            train_cfg.get("checkpoint_path", "."), "profile")))

    phases = [Phase("train", datasets["train"], grad=True),
              Phase("valid", datasets["valid"], grad=False)]

    # train.start_epoch: resume a crashed run from a per-epoch checkpoint
    # (pair with load_checkpoint).  Offsets the epoch loop, checkpoint
    # names, and the cosine-restarts schedule so the resumed run continues
    # the original trajectory instead of restarting it.
    start_epoch = int(train_cfg.get("start_epoch", 0))
    for phase in phases:
        phase.epoch_nr = start_epoch

    scheduler_kind = train_cfg.get("scheduler", "CosineAnnealingWarmRestarts")
    plateau = optim.ReduceLROnPlateau()
    restart_epochs = float(train_cfg.get("restart_epochs", 3))
    rng = np.random.default_rng(seed)
    steps_done = 0

    with trace:
        for epoch in range(start_epoch, int(train_cfg["training_epochs"])):
            for phase in phases:
                cb.epoch_started(phase=phase)
                order = _sequence_order(
                    len(phase.loader),
                    phase.grad and loader_cfg.get("shuffle", False), rng,
                    mesh if phase.grad else None)
                group = bs // world if phase.grad else 1
                if phase.grad and len(order) < group:
                    raise ValueError(
                        f"batch_size={bs} exceeds the train split's "
                        f"{len(order) * world} sequences: every epoch would "
                        f"run zero optimiser steps. Lower train.batch_size.")
                n_steps_epoch = max(len(order) // group, 1)
                with contextlib.closing(_prefetch(
                        phase.loader[int(i)] for i in order)) as it:
                    for seq_i, seqs in enumerate(_grouped(it, group)):
                        batch = engine.SeqBatch.stack(seqs, dev)
                        if phase.grad:
                            if scheduler_kind == "CosineAnnealingWarmRestarts":
                                frac = phase.epoch_nr + seq_i / n_steps_epoch
                                lr_scale = optim.cosine_warm_restarts(
                                    frac, restart_epochs)
                            else:
                                lr_scale = plateau.scale
                            state, logp, metrics = train_step(state, batch,
                                                              lr_scale)
                        else:
                            logp, metrics = eval_step(batch)
                            lr_scale = 0.0

                        preds = _predict(logp)
                        grad_norms = _host_dict(metrics.get("grad_norms"))
                        for bi, frames in enumerate(seqs):
                            last = frames[-1]
                            cb.after_forward_pass(
                                phase=phase, loss=float(metrics["loss"]),
                                loss_dice=float(metrics.get("lovasz", 0.0)),
                                grad_norm=float(metrics.get("grad_norm",
                                                            0.0)),
                                grad_norms=grad_norms,
                                pred_labels=preds[bi][last.mask],
                                nr_classes=cfg.nr_classes,
                                target=last.labels[last.mask],
                                ignore_index=ignore_index, lr=lr_scale)

                        steps_done += 1
                        if root and bool(metrics.get("vertex_overflow",
                                                     False)):
                            print("WARNING: vertex table saturated this "
                                  "sequence (capacity reached; any further "
                                  "vertices were dropped to the invalid "
                                  "bucket); raise runtime.capacity_level0 "
                                  "(see utils/autotune.py)")
                        # periodic fault-tolerance checkpoint (weights,
                        # optimizer and step)
                        every = train_cfg.get("save_every_n_steps", 0)
                        if (phase.grad and every and save
                                and steps_done % every == 0):
                            ckpt.save(os.path.join(
                                train_cfg["checkpoint_path"], "latest.ckpt"),
                                model, state.optimizer, state.step)
                        if max_steps is not None and steps_done >= max_steps:
                            break

                name = ckpt.checkpoint_name(
                    loader_cfg.get("include_moving_classes", False),
                    train_cfg["dataset_name"], cfg.values_mode, rt.sigma,
                    cfg.rnn_modules, cfg.frames_per_seq,
                    loader_cfg.get("cloud_scope", 1), epoch,
                    loader_cfg.get("accumulate_clouds", False))
                if phase.grad and save:
                    path = os.path.join(train_cfg["checkpoint_path"],
                                        name + ".ckpt")
                    ckpt.save(path, model, state.optimizer, state.step)
                    print("saved checkpoint:", path)
                if not phase.grad and scheduler_kind == "ReduceLROnPlateau":
                    plateau.step(phase.loss_acum_per_epoch)
                cb.epoch_ended(phase=phase,
                               checkpoint_path=(train_cfg.get(
                                   "checkpoint_path") if root else None),
                               name=name)
            if max_steps is not None and steps_done >= max_steps:
                break
            trace.close()   # the trace covers the first epoch
    return model, state


def run_eval(config_file: str, split: str = "test",
             max_seqs: int | None = None, datasets=None,
             checkpoint_path: str | None = None, device=None):
    """Evaluation and prediction writing (the reference's test_ln.py): runs
    the chosen split and, with ``eval.do_write_predictions``, writes
    per-point ``.label`` files in the semantic-kitti-api submission layout.
    Returns ``(mean IoU, phase)``."""
    parser = cfgParser(config_file)
    eval_cfg = parser.get_eval_vars()
    loader_cfg = parser.get_loader_vars()
    label_cfg = parser.get_label_mngr_vars()
    ignore_index = label_cfg.get("unlabeled_idx", 0)
    cfg, rt, dev = _setup(parser, device)

    model, state = engine.create_train_state(cfg, rt, lr=1e-3,
                                             weight_decay=0.0, device=dev)
    _, eval_step = engine.make_train_step(model, cfg, rt, ignore_index)

    path = checkpoint_path or (
        os.path.join(eval_cfg["checkpoint_path"],
                     eval_cfg["load_checkpoint_model"])
        if eval_cfg.get("load_checkpoint_model") else None)
    if path:
        ckpt.load(path, model, cfg=cfg)
        print("loaded checkpoint:", path)

    if datasets is None:
        datasets = make_datasets(parser, cfg, rt, splits=(split,))
    ds = datasets[split]

    phase = Phase(split, ds, grad=False)
    cb = CallbacksGroup([StateCallback()])
    cb.epoch_started(phase=phase)

    write_preds = eval_cfg.get("do_write_predictions", False)
    out_root = eval_cfg.get("output_predictions_path", "./predictions")

    with contextlib.closing(_prefetch(iter(ds))) as it:
        for seq_i, frames in enumerate(it):
            batch = engine.SeqBatch.stack([frames], dev)
            logp, metrics = eval_step(batch)
            last = frames[-1]
            pred = _predict(logp)[0][last.mask]
            cb.after_forward_pass(
                phase=phase, loss=float(metrics["loss"]),
                pred_labels=pred, nr_classes=cfg.nr_classes,
                target=last.labels[last.mask],
                ignore_index=ignore_index, lr=0.0)

            if write_preds:
                # semantic-kitti-api layout:
                # predictions/sequences/<seq>/predictions/<scan>.label
                # In ACCUM mode only the LAST scan's points are written
                # (upstream test_ln.py:221: l_pred[-len_seq[-1]:]); scoring
                # above keeps every accumulated point, as the reference does.
                # The binary devkit format, not the text file the reference
                # overwrites it with.
                base = os.path.splitext(os.path.basename(last.path))[0]
                seq_dir = os.path.basename(
                    os.path.dirname(os.path.dirname(last.path)))
                out_dir = os.path.join(out_root, "sequences", seq_dir,
                                       "predictions")
                os.makedirs(out_dir, exist_ok=True)
                pred_last = pred[-last.last_n:] if last.last_n else pred
                pred_last.astype(np.uint32).tofile(
                    os.path.join(out_dir, base + ".label"))

            if max_seqs is not None and seq_i + 1 >= max_seqs:
                break

    if (write_preds and max_seqs is None
            and parser._dataset_name() != "parislille"):
        # submission completeness report (the reference pipeline's
        # validate_submission.py step) -- informative, not fatal: window
        # clamping at sequence starts can legitimately leave the first
        # frames_per_seq-1 scans without predictions
        from ..evaluate_semantics import validate
        try:
            validate(loader_cfg["dataset_path"], out_root, split=split)
        except (OSError, KeyError, ValueError) as e:
            print(f"submission validation skipped: {e!r}")

    mean_iou = phase.scores.avg_class_iou()
    cb.epoch_ended(phase=phase)
    return mean_iou, phase
