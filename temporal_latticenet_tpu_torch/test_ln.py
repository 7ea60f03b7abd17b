"""Evaluation and submission CLI of the PyTorch port, mirroring the
repository's ``test_ln.py`` (and the reference's ``python test_ln.py
--dataset semantickitti``):

    python -m temporal_latticenet_tpu_torch.test_ln --dataset semantickitti \
        [--config seq_config/lnn_eval_semantic_kitti.cfg] \
        [--split valid|test] [--device cpu]

Writes per-point ``.label`` files in the semantic-kitti-api layout when
``eval.do_write_predictions`` is set; ``data.kitti_meta.build_inverse_lut``
gives the --inverse remap of the official submission pipeline.  Runs on
CUDA unless ``--device`` names another device, and never falls back to the
CPU."""

from __future__ import annotations

import argparse

from .train_ln import config_path

DEFAULT_CONFIGS = {
    "semantickitti": "seq_config/lnn_eval_semantic_kitti.cfg",
    "parislille": "seq_config/lnn_eval_paris_lille.cfg",
}


def run(dataset_name: str = "semantickitti", config_file: str | None = None,
        split: str = "test", device=None):
    from .train.loop import run_eval
    config_file = config_path(dataset_name, config_file, DEFAULT_CONFIGS)
    print("Config file:", config_file)
    miou, _ = run_eval(config_file, split=split, device=device)
    print("mean IoU:", miou)
    return miou


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate on a dataset.")
    parser.add_argument("--dataset", type=str, nargs="?",
                        const="semantickitti", default="semantickitti")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--split", type=str, default="test",
                        choices=["valid", "test"])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    run(args.dataset, args.config, args.split, args.device)


if __name__ == "__main__":
    main()
