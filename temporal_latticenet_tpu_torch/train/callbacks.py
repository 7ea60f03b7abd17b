"""Callback framework + phase state, mirroring the reference's
``callbacks/`` package (upstream callbacks/callback.py:15-89,
phase.py:5, state_callback.py:6, wandb_callback.py:6).

The 12 lifecycle hooks keep their reference names; hooks receive keyword
arguments and ignore what they don't use, so callbacks compose freely.
A copy of the JAX package's ``train/callbacks.py``.  The GL viewer
callback is not reproduced; its role is covered by the headless prediction
writer of ``loop.run_eval``.
"""

from __future__ import annotations

import os

from .metrics import Scores

HOOKS = [
    "training_started", "training_ended", "epoch_started", "epoch_ended",
    "phase_started", "phase_ended", "batch_started", "batch_ended",
    "before_forward_pass", "after_forward_pass",
    "before_backward_pass", "after_backward_pass",
]


class Callback:
    def __getattr__(self, item):
        if item in HOOKS:
            return lambda **kw: None
        raise AttributeError(item)


class CallbacksGroup(Callback):
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __getattr__(self, item):
        if item in HOOKS:
            def fanout(**kw):
                for cb in self.callbacks:
                    getattr(cb, item, lambda **k: None)(**kw)
            return fanout
        raise AttributeError(item)


class Phase:
    """Per-phase bookkeeping (callbacks/phase.py:5-22)."""

    def __init__(self, name: str, loader, grad: bool):
        self.name = name
        self.loader = loader
        self.grad = grad
        self.iter_nr = 0
        self.epoch_nr = 0
        self.samples_processed_this_epoch = 0
        self.scores = Scores()
        self.loss_acum_per_epoch = 0.0


class StateCallback(Callback):
    """Counters, loss accumulation, IoU printing and CSV export
    (callbacks/state_callback.py:6-48)."""

    def after_forward_pass(self, *, phase=None, loss=0.0, pred_logits=None,
                           pred_labels=None, nr_classes=None,
                           target=None, ignore_index=0, **kw):
        if phase is None:
            return
        phase.iter_nr += 1
        phase.samples_processed_this_epoch += 1
        phase.loss_acum_per_epoch += float(loss)
        # pred_labels: already-argmaxed predictions (the loop argmaxes on
        # the device and copies (P,) int32, not (P, classes) float32
        # log-probabilities); pred_logits kept for API compatibility
        if pred_labels is not None and target is not None:
            phase.scores.accumulate_scores(pred_labels, target, ignore_index,
                                           nr_classes=nr_classes)
        elif pred_logits is not None and target is not None:
            phase.scores.accumulate_logits(pred_logits, target, ignore_index)

    def epoch_started(self, *, phase=None, **kw):
        if phase is None:
            return
        phase.loss_acum_per_epoch = 0.0
        phase.samples_processed_this_epoch = 0
        phase.scores.start_fresh_eval()

    def epoch_ended(self, *, phase=None, checkpoint_path=None, name=None, **kw):
        if phase is None:
            return
        mean_iou = phase.scores.avg_class_iou()
        phase.scores.update_best()
        print(f"epoch {phase.epoch_nr} ({phase.name}) mean IoU {mean_iou:.4f}")
        if phase.name == "valid" and checkpoint_path and name:
            os.makedirs(checkpoint_path, exist_ok=True)
            phase.scores.write_iou_to_csv(
                os.path.join(checkpoint_path, f"{name}.csv"))
        phase.epoch_nr += 1


class WandBCallback(Callback):
    """Optional wandb logging (callbacks/wandb_callback.py:6-50); degrades
    to a no-op when wandb is unavailable or offline."""

    def __init__(self, experiment_name: str, config: dict, entity=None):
        try:
            import wandb
            self.wandb = wandb
            self.run = wandb.init(project=experiment_name, entity=entity,
                                  config=config)
        except Exception:
            self.wandb = None
            self.run = None

    def after_forward_pass(self, *, phase=None, loss=0.0, loss_dice=0.0,
                           lr=0.0, grad_norm=None, grad_norms=None, **kw):
        if self.wandb and phase is not None and phase.grad:
            log = {"loss": loss, "loss_dice": loss_dice, "lr": lr}
            # gradient observability, the analog of wandb.watch(model)
            # (reference callbacks/wandb_callback.py:18): the global norm
            # plus -- when engine watch_grads is on -- one norm per
            # parameter leaf
            if grad_norm is not None:
                log["grad_norm"] = grad_norm
            if grad_norms:
                log.update({f"grad_norm/{k}": float(v)
                            for k, v in grad_norms.items()})
            self.wandb.log(log)

    def epoch_ended(self, *, phase=None, **kw):
        if self.wandb and phase is not None:
            mean_iou = phase.scores.avg_class_iou()
            self.wandb.log({f"{phase.name}_iou": mean_iou,
                            f"{phase.name}_best_iou": phase.scores.best_iou})


class PlotCallback(Callback):
    """Headless replacement for the reference's visdom loss curves
    (callbacks/visdom_callback.py:4-19, callbacks/vis.py:10-49): collects
    smoothed per-step losses and writes matplotlib PNGs + a CSV at each
    epoch end."""

    def __init__(self, out_dir: str = "./plots", smooth: float = 0.9):
        self.out_dir = out_dir
        self.smooth = smooth
        self.series: dict = {}

    def _log(self, name, value):
        s = self.series.setdefault(name, {"raw": [], "smoothed": [], "ema": None})
        ema = value if s["ema"] is None else (
            self.smooth * s["ema"] + (1 - self.smooth) * value)
        s["ema"] = ema
        s["raw"].append(float(value))
        s["smoothed"].append(float(ema))

    def after_forward_pass(self, *, phase=None, loss=0.0, lr=0.0, **kw):
        if phase is not None and phase.grad:
            self._log("loss", loss)
            self._log("lr", lr)

    def epoch_ended(self, *, phase=None, **kw):
        if phase is None or not self.series:
            return
        os.makedirs(self.out_dir, exist_ok=True)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            plt = None
        import csv
        for name, s in self.series.items():
            with open(os.path.join(self.out_dir, f"{name}.csv"), "w") as f:
                w = csv.writer(f)
                w.writerows(enumerate(s["raw"]))
            if plt is not None:
                fig, ax = plt.subplots(figsize=(7, 4))
                ax.plot(s["raw"], alpha=0.3, label="raw")
                ax.plot(s["smoothed"], label="smoothed")
                ax.set_title(name)
                ax.legend()
                fig.savefig(os.path.join(self.out_dir, f"{name}.png"), dpi=110)
                plt.close(fig)
