"""Offline semantic evaluation of saved predictions against ground truth
(this package's copy of the repository's root ``evaluate_semantics.py``,
which imports the JAX package; this module imports none of it).

    python -m temporal_latticenet_tpu_torch.evaluate_semantics \
        --dataset <root> --predictions <root> [--validate]

Native replacement for the external semantic-kitti-api scripts the reference
defers to (``remap_semantic_labels.py --inverse`` / ``evaluate_semantics.py``
/ ``validate_submission.py`` -- upstream test_ln.py:234-248):

* reads ``.label`` predictions in the submission layout
  (``<pred_root>/sequences/<seq>/predictions/<scan>.label``);
* reads ground truth from the dataset layout, remapping raw labels through
  the learning map;
* supports predictions stored either as TRAINING ids (our test_ln output)
  or as RAW ids (a remapped submission) via ``--pred-format``;
* optional ``--remap-inverse`` rewrites training-id predictions to raw ids
  in place, producing a codalab-uploadable tree (the --inverse step);
* prints per-class and mean IoU (the official devkit metric);
* ``--validate`` checks submission completeness first (the
  validate_submission.py analog): every scan of every sequence in the
  split must have a prediction file whose point count matches the scan,
  and no stray prediction files may exist; non-zero exit on failure.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .data import kitti_meta
from .train.metrics import Scores
from .utils.label_mngr import LabelMngr


def iter_scans(pred_root: str, sequences):
    for seq in sequences:
        pat = os.path.join(pred_root, "sequences", f"{seq:02d}", "predictions",
                           "*.label")
        for p in sorted(glob.glob(pat)):
            yield seq, int(os.path.splitext(os.path.basename(p))[0]), p


def validate(dataset_path: str, pred_root: str, split: str = "valid"):
    """Submission-layout completeness check (validate_submission.py analog,
    upstream test_ln.py:234-248).

    Expected scans are enumerated from the dataset's ``velodyne`` dirs
    (falling back to ``labels`` when velodyne is absent, e.g. the synthetic
    test fixtures); the expected point count comes from the scan file size
    (16 bytes/point for .bin, 4 for .label).  Returns a report dict with
    ``ok`` plus missing / mis-sized / extra prediction file lists.
    """
    missing, mis_sized, extra = [], [], []
    n_expected = 0
    for seq in kitti_meta.SPLIT[split]:
        seq_dir = os.path.join(dataset_path, "sequences", f"{seq:02d}")
        vel = sorted(glob.glob(os.path.join(seq_dir, "velodyne", "*.bin")))
        if vel:
            expected = {int(os.path.splitext(os.path.basename(p))[0]):
                        os.path.getsize(p) // 16 for p in vel}
        else:
            lab = sorted(glob.glob(os.path.join(seq_dir, "labels", "*.label")))
            expected = {int(os.path.splitext(os.path.basename(p))[0]):
                        os.path.getsize(p) // 4 for p in lab}
        n_expected += len(expected)
        pred_dir = os.path.join(pred_root, "sequences", f"{seq:02d}",
                                "predictions")
        have = {int(os.path.splitext(os.path.basename(p))[0]): p
                for p in glob.glob(os.path.join(pred_dir, "*.label"))}
        for scan, npts in sorted(expected.items()):
            if scan not in have:
                missing.append(os.path.join(pred_dir, f"{scan:06d}.label"))
            elif os.path.getsize(have[scan]) // 4 != npts:
                mis_sized.append(
                    f"{have[scan]}: {os.path.getsize(have[scan]) // 4} "
                    f"predictions vs {npts} points")
        extra.extend(p for s, p in sorted(have.items()) if s not in expected)

    ok = n_expected > 0 and not (missing or mis_sized or extra)
    report = {"ok": ok, "split": split, "scans_expected": n_expected,
              "missing": missing, "mis_sized": mis_sized, "extra": extra}
    if n_expected == 0:
        print(f"VALIDATION FAILED: no scans found for split '{split}' under "
              f"{dataset_path}")
    elif ok:
        print(f"validation OK: {n_expected} scans of split '{split}' all "
              f"have correctly sized predictions")
    else:
        for name in ("missing", "mis_sized", "extra"):
            for item in report[name]:
                print(f"  {name}: {item}")
        print(f"VALIDATION FAILED: {len(missing)} missing, "
              f"{len(mis_sized)} mis-sized, {len(extra)} extra prediction "
              f"files over {n_expected} expected scans")
    return report


def run(dataset_path: str, pred_root: str, split: str = "valid",
        include_moving: bool = True, pred_format: str = "train",
        remap_inverse: bool = False, limit: int | None = None):
    lut = kitti_meta.build_remap_lut(include_moving)
    inv = kitti_meta.build_inverse_lut(include_moving)
    mngr = LabelMngr(dataset="semantickitti", include_moving=include_moving)
    scores = Scores()
    sequences = kitti_meta.SPLIT[split]

    n = 0
    missing_gt = []
    for seq, scan, pred_path in iter_scans(pred_root, sequences):
        pred = np.fromfile(pred_path, dtype=np.uint32)
        if pred_format == "raw":
            pred_train = lut[pred & 0xFFFF]
        else:
            pred_train = pred.astype(np.int64)
            if remap_inverse:
                inv[pred_train].astype(np.uint32).tofile(pred_path)

        gt_path = os.path.join(dataset_path, "sequences", f"{seq:02d}",
                               "labels", f"{scan:06d}.label")
        if not os.path.exists(gt_path):
            # never silently skipped: the scan is excluded
            # from the IoU but loudly reported below
            missing_gt.append(gt_path)
            continue
        raw = np.fromfile(gt_path, dtype=np.uint32)
        gt = lut[raw & 0xFFFF]
        if pred_train.shape[0] != gt.shape[0]:
            raise SystemExit(
                f"{pred_path}: {pred_train.shape[0]} predictions vs "
                f"{gt.shape[0]} ground-truth points")
        scores.accumulate_scores(pred_train, gt, unlabeled_idx=0,
                                 nr_classes=mngr.nr_classes())
        n += 1
        if limit and n >= limit:
            break

    if missing_gt:
        print(f"WARNING: {len(missing_gt)} prediction scans had no ground "
              f"truth and were excluded (first: {missing_gt[0]})")
    if n == 0:
        raise SystemExit("no (prediction, ground truth) pairs found")
    avg, per_class = scores.compute_stats()
    for idx, iou in sorted(per_class.items()):
        print(f"  {mngr.label_name(idx):<24s} {iou:.4f}")
    print(f"mean IoU over {len(per_class)} classes, {n} scans: {avg:.4f}")
    return avg, per_class


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--split", default="valid", choices=["train", "valid"])
    ap.add_argument("--single-scan", action="store_true",
                    help="20-class setting (no moving classes)")
    ap.add_argument("--pred-format", default="train", choices=["train", "raw"])
    ap.add_argument("--remap-inverse", action="store_true",
                    help="rewrite train-id predictions to raw ids in place")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--validate", action="store_true",
                    help="check submission completeness (every scan of the "
                    "split has a correctly sized prediction file) before "
                    "evaluating; non-zero exit on failure")
    a = ap.parse_args(argv)
    if a.validate:
        report = validate(a.dataset, a.predictions, a.split)
        if not report["ok"]:
            raise SystemExit(1)
    run(a.dataset, a.predictions, a.split, not a.single_scan, a.pred_format,
        a.remap_inverse, a.limit)


if __name__ == "__main__":
    main()
