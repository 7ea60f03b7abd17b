"""IoU metrics (a copy of the JAX package's): a NumPy port of the reference's running-score accumulator
(``Scores``, upstream callbacks/scores.py:8-96): streaming per-class
intersection/union ignoring the unlabeled index, mean IoU over classes with
nonzero union, best-epoch tracking and CSV export."""

from __future__ import annotations

import csv

import numpy as np


class Scores:
    def __init__(self):
        self.clear()

    def accumulate_scores(self, pred_labels: np.ndarray, gt: np.ndarray,
                          unlabeled_idx: int, nr_classes: int | None = None):
        """pred_labels: (P,) int predictions (argmax already taken, unlike
        the reference which takes softmax -- both supported via
        accumulate_logits)."""
        pred = np.asarray(pred_labels).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        if nr_classes is not None:
            self.nr_classes = nr_classes
        elif self.nr_classes is None:
            self.nr_classes = int(max(pred.max(), gt.max())) + 1

        if self.intersection_per_class is None:
            self.intersection_per_class = np.zeros(self.nr_classes, np.int64)
            self.union_per_class = np.zeros(self.nr_classes, np.int64)

        for l in np.unique(gt):
            if l == unlabeled_idx:
                continue
            inter = int(((pred == gt) & (gt == l)).sum())
            self.intersection_per_class[l] += inter
            self.union_per_class[l] += int((gt == l).sum()) + int((pred == l).sum()) - inter

    def accumulate_logits(self, logits: np.ndarray, gt: np.ndarray,
                          unlabeled_idx: int):
        self.accumulate_scores(np.argmax(logits, axis=1), gt, unlabeled_idx,
                               nr_classes=logits.shape[1])

    def compute_stats(self, print_per_class_iou: bool = False):
        iou_dict = {}
        iou_sum, valid = 0.0, 0
        for i in range(self.nr_classes or 0):
            if self.union_per_class is not None and self.union_per_class[i] > 0:
                iou = self.intersection_per_class[i] / self.union_per_class[i]
                iou_dict[i] = float(iou)
                iou_sum += iou
                valid += 1
                if print_per_class_iou:
                    print(f"class iou for idx {i} is {iou}")
        avg = iou_sum / valid if valid else 0.0
        return avg, iou_dict

    def avg_class_iou(self, print_per_class_iou: bool = False) -> float:
        return self.compute_stats(print_per_class_iou)[0]

    def iou_per_class(self) -> dict:
        return self.compute_stats()[1]

    def update_best(self):
        avg, d = self.compute_stats()
        if avg > self.best_iou:
            self.best_iou = avg
            self.best_iou_dict = d

    def start_fresh_eval(self):
        self.intersection_per_class = None
        self.union_per_class = None
        self.nr_classes = None

    def clear(self):
        self.start_fresh_eval()
        self.best_iou = -np.inf
        self.best_iou_dict = {}

    def write_iou_to_csv(self, filename: str):
        avg, d = self.compute_stats()
        with open(filename, "w") as f:
            w = csv.writer(f)
            for k, v in d.items():
                w.writerow([k, v])
            w.writerow(["mean_iou", avg])

    def write_best_iou_to_csv(self, filename: str):
        with open(filename, "w") as f:
            w = csv.writer(f)
            for k, v in self.best_iou_dict.items():
                w.writerow([k, v])
            w.writerow(["best_iou", self.best_iou])
